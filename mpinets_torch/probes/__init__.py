"""The TPU on-chip probes of ``scripts/``, ported to the H100.

The JAX package measured its SA0 scan and Mosaic's limits with six Pallas
kernels that live in session scripts (``scripts/onchip_r3b.py``,
``onchip_r3c.py``, ``onchip_r3d.py``, ``onchip_r4a.py``). Their CUDA
counterparts are four kernels in ``csrc/probes.cu``:

* :mod:`.scan` -- the SA0 ball-query scan cut off after one of its stages
  (``_abl_kernel`` of r3b and r3d, ``_abl2_kernel`` of r3c);
* :mod:`.micro` -- the micro-ops of r3d's ``_micro_kernel``;
* :mod:`.design` -- r4a's wide-index gather (``_wide_kernel``) and scratch
  persistence (``_scratch_kernel``).

Each wrapper computes its plain PyTorch version on CPU tensors and launches
its kernel on CUDA tensors (or raises). :mod:`.session` runs the scripts'
sessions -- each probe held against its plain version and timed by the
long-minus-short loop -- as ``python -m mpinets_torch.probes``.
"""
