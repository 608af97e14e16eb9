"""MIB field tables (36.331 MasterInformationBlock; reference:
src/searcher.cpp:1650-1692)."""

N_RB_DL_TABLE = {0: 6, 1: 15, 2: 25, 3: 50, 4: 75, 5: 100}
PHICH_RES_TABLE = {0: 1 / 6, 1: 1 / 2, 2: 1.0, 3: 2.0}
