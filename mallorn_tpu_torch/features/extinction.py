"""Extinction-corrected (dereddened) color features, the v57 family (port
of ``mallorn_tpu.features.extinction``; host numpy, the JAX package's
code). From the reference's script-level transform
(reference: scripts/train_v57_extinction_corrected.py:39-177): every
feature column whose name contains a color-pair key (g_r, r_i, u_g,
i_z — FIRST matching pair wins, mirroring the script's ``break``) gets
an appended ``<pair>_dered`` twin with the Milky-Way color excess
E(b1-b2) = A_b1 - A_b2 subtracted. A_band uses the script's documented
per-band linear coefficients A = c_band * E(B-V) (its fallback when the
``extinction`` package — absent here and optional there — is
unavailable; :77-82); NaN or non-positive EBV means zero correction,
NaN feature values stay NaN (:85-117).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

# A_lambda / E(B-V) for R_V = 3.1
# (reference: train_v57_extinction_corrected.py:44-47)
FALLBACK_COEFFS = {
    "u": 4.81, "g": 3.64, "r": 2.70,
    "i": 2.06, "z": 1.58, "y": 1.31,
}

COLOR_PAIRS = (("g", "r"), ("r", "i"), ("u", "g"), ("i", "z"))


def color_excess(ebv: np.ndarray, band1: str, band2: str) -> np.ndarray:
    """E(band1 - band2) per object; 0 for NaN or non-positive EBV."""
    ebv = np.asarray(ebv, np.float64)
    ok = np.isfinite(ebv) & (ebv > 0)
    coeff = FALLBACK_COEFFS[band1] - FALLBACK_COEFFS[band2]
    return np.where(ok, ebv * coeff, 0.0)


def dered_matrix(X: np.ndarray, names: Sequence[str],
                 ebv: np.ndarray) -> Tuple[np.ndarray, List[str]]:
    """Appended ``_dered`` columns for every color-pair-named feature.

    Substring matching is DELIBERATELY loose to mirror the reference
    script's bug: ``'g_r' in name`` also hits non-color features whose
    names merely contain the token (e.g. ``*_g_rise*`` -> a nonsense
    ``..._g_r_deredise`` twin with an extinction offset subtracted from a
    time feature). The reference v57 feature set includes those bogus
    twins, so exact v57 parity requires reproducing them — do not tighten
    to token-boundary matching without breaking the contract.

    Returns ([N, K] extra columns, their names); K may be 0."""
    X = np.asarray(X)
    cols, out_names = [], []
    for j, name in enumerate(names):
        for b1, b2 in COLOR_PAIRS:
            key = f"{b1}_{b2}"
            if key in name and "_dered" not in name:
                cols.append(X[:, j] - color_excess(ebv, b1, b2))
                out_names.append(name.replace(key, f"{key}_dered"))
                break
    if not cols:
        return np.zeros((len(X), 0), X.dtype), []
    return np.stack(cols, axis=1).astype(X.dtype), out_names
