"""The comparison that decides ``correct``.

Each number compared comes with its limit; a run is correct when every
number is at or under its limit. The limits live in the configuration's
file (``check``), each set from the readings that ``PERF.md`` gives.

Search cells: the reference (:mod:`benchmark.reference.search`, float64)
runs once over each sampled capture, and the program's cells of that
capture are held to its cells:

- ``cells_differ``: captures whose cells differ in PCI, CP, RB, antenna
  ports, SFN or PHICH (exact: limit 0);
- ``pss_pow_gap``: the widest relative gap of a cell's scan peak power;
- ``foff_gap_hz``: the widest gap of a cell's frequency offset.

Tracker cells: the reference searches the first capture of the stream
that ``kalibrate`` saw, and the tracker's answers after the window are
held to what it finds:

- ``cells_differ``: cells held but not found, found but not held, or
  held with another MIB (ports, CP, RB, PHICH) (exact: limit 0); a cell
  is held when its MIB decoded at least once in the window;
- ``mib_miss_share``: the worst cell's share of the window's 40 ms PBCH
  periods without a MIB decode.

Each entry runs the reference over its own answers (``Entry.numbers``).
"""

from __future__ import annotations

from typing import Dict, Tuple

MIB_FIELDS = ("n_ports", "cp_type", "n_rb_dl", "phich_duration",
              "phich_resource")
SEARCH_FIELDS = MIB_FIELDS + ("sfn",)


def _cell_key(c) -> Tuple:
    return (c.n_id_cell(),) + tuple(getattr(c, f) for f in SEARCH_FIELDS)


def compare_search(pairs) -> Dict[str, float]:
    """``pairs``: (program cells, reference cells) of each sampled
    capture."""
    differ, pow_gap, foff_gap = 0, 0.0, 0.0
    for prog, ref in pairs:
        if sorted(map(_cell_key, prog)) != sorted(map(_cell_key, ref)):
            differ += 1
        by_pci = {c.n_id_cell(): c for c in ref}
        for c in prog:
            r = by_pci.get(c.n_id_cell())
            if r is None:
                continue
            pow_gap = max(pow_gap, abs(c.pss_pow / r.pss_pow - 1.0))
            foff_gap = max(foff_gap, abs(c.freq_superfine - r.freq_superfine))
    return {"cells_differ": differ, "pss_pow_gap": pow_gap,
            "foff_gap_hz": foff_gap}


def compare_tracker(answers: dict, ref) -> Dict[str, float]:
    """``answers``: the tracker's (TrackerEntry.finish); ``ref``: the
    reference's cells of the first capture."""
    # A cell is held when its MIB decoded in the window; a tracked cell
    # that never did is on its way out (health falling) and not held.
    tracked = {c["pci"]: c for c in answers["cells"] if c["mib_in_window"]}
    found = {c.n_id_cell(): c for c in ref}
    differ = len(set(tracked) ^ set(found))
    for pci in set(tracked) & set(found):
        if any(tracked[pci][f] != getattr(found[pci], f)
               for f in MIB_FIELDS):
            differ += 1
    out = {"cells_differ": differ}
    if found:
        periods = max(1, answers["periods"])
        out["mib_miss_share"] = max(
            max(0.0, 1.0 - tracked[pci]["mib_in_window"] / periods)
            if pci in tracked else 1.0 for pci in found)
    return out


def judge(numbers: Dict[str, float], limits: Dict[str, float]
          ) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """(correct, {name: {value, limit}}). A number without a limit is
    not correct."""
    checks = {k: {"value": float(v), "limit": float(limits[k])}
              for k, v in numbers.items() if k in limits}
    ok = (set(numbers) <= set(limits)
          and all(c["value"] <= c["limit"] for c in checks.values()))
    for k in set(numbers) - set(limits):
        checks[k] = {"value": float(numbers[k]), "limit": float("nan")}
    return ok, checks
