"""Survey constants (copy of ``mallorn_tpu.utils.constants``).

LSST band order and central wavelengths; the port keeps its own copy so
it never imports the JAX package.
"""

LSST_BANDS = ("u", "g", "r", "i", "z", "y")
N_BANDS = len(LSST_BANDS)

BAND_INDEX = {b: i for i, b in enumerate(LSST_BANDS)}

# Central wavelengths in nanometres.
BAND_WAVELENGTHS_NM = {
    "u": 367.0,
    "g": 482.5,
    "r": 622.2,
    "i": 754.5,
    "z": 869.1,
    "y": 971.0,
}

# Effective wavelengths in Angstroms (used by temperature / GP features).
BAND_WAVELENGTHS_A = {
    "u": 3670.0,
    "g": 4825.0,
    "r": 6222.0,
    "i": 7545.0,
    "z": 8691.0,
    "y": 9710.0,
}

WAVELENGTHS_NM = tuple(BAND_WAVELENGTHS_NM[b] for b in LSST_BANDS)
WAVELENGTHS_A = tuple(BAND_WAVELENGTHS_A[b] for b in LSST_BANDS)

# Sentinel used to pad time arrays so that a time-sort keeps real
# observations in front of padding.
TIME_PAD = 1.0e9
