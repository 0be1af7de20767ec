"""Physical constants in CGS units (IAU 2015 nominal values / CODATA
2018), the values the reference framework takes from ``astropy.constants``.
Same numbers as the JAX package's ``constants.py``."""

import numpy as np

MSUN = 1.988409870698051e33  # g
RSUN = 6.957e10  # cm
REARTH = 6.3781e8  # cm
G = 6.6743e-8  # cm^3 g^-1 s^-2
AU = 1.49597870700e13  # cm

PI = np.pi
LN2PI = np.log(2 * np.pi)

DAY_S = 86400.0  # seconds per day
