"""Spectral arc length (SPARC) smoothness metric.

Port of ``mpinets_tpu/eval/sparc.py`` (after the reference's
``mpinets/third_party/sparc.py:102-128``, called from
``mpinets/metrics.py:386-409`` with ``fs = 1/dt``). Definition
(Balasubramanian et al., 2015): the negative arc length of the
frequency-normalized magnitude spectrum of the speed profile, restricted to
a low-pass band [0, fc] and then trimmed to the first..last samples above
an amplitude threshold.

* :func:`sparc` -- scalar numpy version (the port's own copy of the JAX
  package's, line for line). The :class:`mpinets_torch.eval.metrics.Evaluator`
  runs it on the host, where per-problem trajectory lengths vary.
* :func:`sparc_batched` -- torch version for fixed-length speed profiles
  on any device, the data-dependent threshold window written as masks.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def sparc(
    movement: np.ndarray,
    fs: float,
    padlevel: int = 4,
    fc: float = 10.0,
    amp_th: float = 0.05,
) -> float:
    """Spectral arc length of a 1-D speed profile. More negative = smoother.

    Returns 0.0 for an all-zero profile (the reference's convention for a
    policy that never moves, ``sparc.py:98-100``).
    """
    movement = np.asarray(movement, dtype=np.float64)
    if np.allclose(movement, 0):
        return 0.0
    nfft = int(2 ** (math.ceil(math.log2(len(movement))) + padlevel))
    freqs = np.arange(0, fs, fs / nfft)
    mag = np.abs(np.fft.fft(movement, nfft))
    mag = mag / mag.max()

    # Low-pass band, then amplitude-threshold trim to [first, last] >= amp_th.
    band = freqs <= fc
    f_sel, m_sel = freqs[band], mag[band]
    above = np.flatnonzero(m_sel >= amp_th)
    f_sel = f_sel[above[0] : above[-1] + 1]
    m_sel = m_sel[above[0] : above[-1] + 1]

    df = np.diff(f_sel) / (f_sel[-1] - f_sel[0])
    dm = np.diff(m_sel)
    return float(-np.sum(np.sqrt(df * df + dm * dm)))


def sparc_batched(
    movement: torch.Tensor,
    fs: float,
    padlevel: int = 4,
    fc: float = 10.0,
    amp_th: float = 0.05,
) -> torch.Tensor:
    """Batched SPARC over fixed-length speed profiles.

    :param movement: [..., T] speed profiles (all the same length T).
    :returns: [...] spectral arc lengths.

    A frequency-step segment contributes to the arc length iff it lies
    between the first and last above-threshold samples of the low-passed
    spectrum, so no shape depends on the data.
    """
    t = movement.shape[-1]
    nfft = int(2 ** (math.ceil(math.log2(t)) + padlevel))
    dev = movement.device
    freqs = torch.arange(nfft, dtype=movement.dtype, device=dev) * (fs / nfft)
    mag = torch.abs(torch.fft.fft(movement, n=nfft, dim=-1))
    mag = mag / mag.amax(dim=-1, keepdim=True)

    band = freqs <= fc                                   # [nfft]
    above = band & (mag >= amp_th)                       # [..., nfft]
    idx = torch.arange(nfft, device=dev)
    first = torch.where(above, idx, nfft).amin(dim=-1)   # [...]
    last = torch.where(above, idx, -1).amax(dim=-1)

    in_window = (idx >= first[..., None]) & (idx <= last[..., None]) & band
    # Segment k spans samples k -> k+1; valid iff both endpoints in window.
    seg = in_window[..., :-1] & in_window[..., 1:]

    f_lo = freqs[first.clamp(min=0, max=nfft - 1)]
    f_hi = freqs[last.clamp(min=0)]
    f_range = torch.clamp(f_hi - f_lo, min=1e-12)

    df = torch.diff(freqs) / f_range[..., None]
    dm = torch.diff(mag, dim=-1)
    arc = -torch.where(seg, torch.sqrt(df * df + dm * dm), 0.0).sum(dim=-1)

    all_zero = torch.all(torch.abs(movement) <= 1e-8, dim=-1)
    return torch.where(all_zero, torch.zeros_like(arc), arc)
