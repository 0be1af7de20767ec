"""Column orders of the packed star tables the samplers draw rows from.

``scenarios/api.py`` packs each table into one (N_rows, F) float32 matrix
in these orders; ``scenarios/engine.py`` gathers a draw's row once, and
``csrc/samplers.cu`` reads the TRILEGAL columns at the same offsets
(``ops/sampler_kernels.py`` checks the order against the library's).
"""

# the background (TRILEGAL) table
BG_PACK_FIELDS = ("fluxratios", "delta_band", "masses", "radii", "loggs",
                  "teffs", "u1s", "u2s", "fluxratios_cc")
# the Tmag +/- 1 lookalike table
POP_PACK_FIELDS = ("masses", "radii", "loggs", "teffs", "u1s", "u2s")
