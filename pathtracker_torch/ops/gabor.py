"""Gabor filter bank generator (pathtracker_tpu/ops/gabor.py) — exact
re-derivation of the reference asset.

The reference ships a precomputed (25,1,7,7) float32 Gabor bank
(reference utils/gabor_serre.npy) used as frozen conv0 weights in its
ConvLSTM and ST-LSTM models (reference models/convlstm.py:104-106,
ffstlstm.py:29). Rather than copying the binary asset, this module
regenerates it from its (recovered) closed-form recipe — the classic
Serre-HMAX 7x7 S1 parameters:

    sigma = 2.8, lambda = 3.5, gamma = 0.3 (aspect), circular aperture of
    radius 3 (29-pixel disk), per-filter whole-grid mean subtraction, unit
    L2 normalization.

Layout (recovered by per-filter least squares against the asset; the
reconstruction matches every filter to float32 machine precision,
max |delta| = 1.4e-8 — pinned by tests/test_aux_parity.py):

  * filters  0-11: even phase (psi = 0), orientations theta_i = 90 - 15*i
    degrees (i = 0..11, NOT folded mod 180);
  * filters 12-23: second phase psi = 2.035405714034181 rad (~116.62 deg;
    the asset's historical quirk — close to, but measurably distinct from,
    pi/2 + 2*pi*sin(15 deg)/lambda), same orientation sequence;
  * filter 24: the aperture disk itself, normalized to unit mean
    (mask / mask.mean() — a 49/29-valued low-pass).
"""

from __future__ import annotations

import numpy as np

# Serre-HMAX size-7 S1 parameters (recovered exactly; see module docstring).
_SIGMA = 2.8
_LAMBDA = 3.5
_GAMMA = 0.3
_PSI2 = 2.035405714034181  # second-phase offset of the reference asset


def gabor_serre_bank() -> np.ndarray:
    """The reference's exact 25-filter bank, OIHW [25, 1, 7, 7] float32
    (reference utils/gabor_serre.npy layout)."""
    yy, xx = np.mgrid[-3:4, -3:4].astype(np.float64)
    mask = (xx**2 + yy**2) <= 9.0
    filters = []
    for psi in (0.0, _PSI2):
        for i in range(12):
            theta = np.radians(90.0 - 15.0 * i)
            xr = xx * np.cos(theta) + yy * np.sin(theta)
            yr = -xx * np.sin(theta) + yy * np.cos(theta)
            g = (np.exp(-(xr**2 + (_GAMMA * yr) ** 2) / (2 * _SIGMA**2))
                 * np.cos(2 * np.pi * xr / _LAMBDA + psi))
            g = g * mask
            g -= g.mean()
            filters.append(g / np.linalg.norm(g))
    filters.append(mask / mask.mean())
    return np.stack(filters)[:, None].astype(np.float32)


def gabor_bank(n_filters: int = 25, size: int = 7, in_channels: int = 1) -> np.ndarray:
    """Returns an HWIO [size, size, in_channels, n_filters] float32 bank.

    For the reference configuration (25 filters, 7x7) this is the exact
    gabor_serre.npy bank transposed to HWIO; other sizes fall back to an
    analytic Serre-style bank with the same parameter family."""
    if n_filters == 25 and size == 7:
        bank = gabor_serre_bank()[:, 0]  # [25, 7, 7]
        bank = np.transpose(bank, (1, 2, 0))[:, :, None, :]  # HWIO
    else:
        bank = _analytic_bank(n_filters, size)
    if in_channels > 1:
        bank = np.repeat(bank, in_channels, axis=2) / in_channels
    return bank.astype(np.float32)


def _analytic_bank(n_filters: int, size: int) -> np.ndarray:
    """Serre-style bank for non-reference sizes: n-1 oriented gabors over
    two phases + the aperture disk, scaled from the size-7 parameters."""
    half = size // 2
    yy, xx = np.mgrid[-half:half + 1, -half:half + 1].astype(np.float64)
    mask = (xx**2 + yy**2) <= half**2
    scale = size / 7.0
    sigma, lam = _SIGMA * scale, _LAMBDA * scale
    filters = []
    n_orient = max((n_filters - 1 + 1) // 2, 1)
    for psi in (0.0, _PSI2):
        for i in range(n_orient):
            if len(filters) >= n_filters - 1:
                break
            theta = np.radians(90.0 - (180.0 / n_orient) * i)
            xr = xx * np.cos(theta) + yy * np.sin(theta)
            yr = -xx * np.sin(theta) + yy * np.cos(theta)
            g = (np.exp(-(xr**2 + (_GAMMA * yr) ** 2) / (2 * sigma**2))
                 * np.cos(2 * np.pi * xr / lam + psi))
            g = g * mask
            g -= g.mean()
            norm = np.linalg.norm(g)
            # Degenerate sizes (e.g. size=1: aperture + mean-subtract zero
            # the filter) must not turn 0/0 into a NaN bank.
            filters.append(g / (norm if norm > 1e-8 else 1.0))
    filters.append(mask / mask.mean())
    bank = np.stack(filters, axis=-1).astype(np.float32)  # [H,W,N]
    return bank[:, :, None, :]
