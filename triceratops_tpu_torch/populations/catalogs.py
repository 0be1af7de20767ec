"""Published FPP catalogs (ground truth for batch replay).

Counterpart of the JAX package's ``populations/catalogs.py``: the result
tables of the two TRICERATOPS papers, read by path from the JAX package's
data directory (never copied), as ``tables.py`` reads its ``.npz`` files:

* ``classified_tois()``: FPP / NFPP of 213 TFOP-classified TOIs at 2-min
  and 30-min cadence (table 4);
* ``unclassified_tois()``: 424 unclassified TOIs (table 5);
* ``vetting_catalog()``: 384 TOIs with FPP / NFPP and the paper's
  classification (table 7).
"""

from __future__ import annotations

from functools import lru_cache

import pandas as pd

from ..tables import DATA_DIR


@lru_cache(maxsize=None)
def _load(name: str) -> pd.DataFrame:
    return pd.read_parquet(DATA_DIR / f"catalog_{name}.parquet")


def classified_tois() -> pd.DataFrame:
    return _load("tab4").copy()


def unclassified_tois() -> pd.DataFrame:
    return _load("tab5").copy()


def vetting_catalog() -> pd.DataFrame:
    return _load("tab7").copy()
