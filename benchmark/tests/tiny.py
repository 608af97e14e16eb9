"""Tiny sizes of the benchmark's cells, for runs on the CPU."""

SEARCH = {"config": {"freq_start": 739.0e6, "freq_end": 739.1e6, "ppm": 10},
          "traffic": {}}
TRACKER = {"config": {"ppm": 10, "blocks_per_status": 40}, "traffic": {}}
SEED = 3000000019


def overrides(cell: str) -> dict:
    src = TRACKER if cell.startswith("tracker") else SEARCH
    return {k: dict(v) for k, v in src.items()}
