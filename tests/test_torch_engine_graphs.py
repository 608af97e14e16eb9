"""The tracker engine's shape buckets and CUDA graphs
(lte_cell_scanner_tpu_torch/tracker/batch_runtime.py).

On the CPU: one recorded engine cycle of the tracked simulated cell 271
(15 dB, tools/bench_tracker's harvest), fed one 10,000-sample block as a
one-cell site runs it, gives through its two programs on the engine's
bucketed and padded plan the real lanes of the same cycle's exact plan, to
the bit: the demod's PBCH symbols, sync measurements and raw CE rows, the
stats' FOE/TOE lanes, emit rows, AC sums, carry rows, ac_td correlations
and the new ac_td history. The stream segment is padded too in the second
case. Below the float16 packing, the sync measurements of a pair keep
their float32 bits whatever pairs lie beside it.

On the card (marked ``card``; skipped without one; this file imports no
JAX, so it runs there with ``python -m pytest --noconftest -m card
tests/test_torch_engine_graphs.py``): the benchmark's one-cell site
tracked with its programs replayed from CUDA graphs and forced eager (the
graph cache monkeypatched to hand out nothing) ends with the same global
frequency offset, frame timing, ac_fd and ac_td bits and MIB decodes, and
the tracer counts two replays a block on graphs; either way the cycle's
upload went through the engine's two pinned buffers
(``utils/device.py::PinnedStaging``).
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from lte_cell_scanner_tpu_torch.parallel.multichip_checks import (
    tracker_cycle)
from lte_cell_scanner_tpu_torch.tracker import batch_runtime as br
from lte_cell_scanner_tpu_torch.utils.device import PinnedStaging
from torch_one_thread import _one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
BLOCK_MS = 10000 / 1.92e6 * 1e3
BUCKET = br._bucket


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.numpy()
    return np.ascontiguousarray(a).view(np.uint8)


def _same(got, want) -> None:
    assert got.shape == want.shape
    np.testing.assert_array_equal(_bits(got), _bits(want))


def _cycle(monkeypatch, bucket):
    """The recorded cycle's programs run on the plan the engine makes with
    ``bucket`` as its ``_bucket``: (demod args, stats args, unpacked demod
    fields, raw CE rows, unpacked stats fields, new ac_td history)."""
    monkeypatch.setattr(br, "_bucket", bucket)
    da, sa = tracker_cycle(1, "cpu", BLOCK_MS)
    flat, ce = br._demod_stream(*da)
    flat2, hist = br._stats(ce, *sa[1:])
    C, Q, K = da[10].shape[0], da[10].shape[1], da[11].shape[1]
    T, E, P = sa[2].shape[0], sa[5].shape[0], sa[0].shape[2]
    demod = br._unpack(flat.numpy(), br.demod_shapes(C, Q, K))
    stats = br._unpack(flat2.numpy(), br.stats_shapes(T, E, C, P))
    return da, sa, demod, ce, stats, hist


@pytest.mark.parametrize("segment", [False, True],
                         ids=["plan", "plan_and_segment"])
def test_padding_is_invisible(monkeypatch, segment):
    """Real lanes of the padded plan's programs equal the exact plan's to
    the bit; the padded plan is larger on every padded axis whose size is
    not a step of its ladder."""
    da, sa, demod, ce, stats, hist = _cycle(monkeypatch,
                                            lambda axis, n: n)
    pad = BUCKET if segment else (
        lambda axis, n: n if axis == "L" else BUCKET(axis, n))
    pda, psa, pdemod, pce, pstats, phist = _cycle(monkeypatch, pad)

    C, S = da[1].shape
    Q, K, R = da[10].shape[1], da[11].shape[1], ce.shape[1]
    T, E = sa[2].shape[0], sa[5].shape[0]
    assert int((sa[4] < C).sum()) == T > 1 and E > 1
    assert pda[1].shape[1] > S and pce.shape[1] > R
    assert psa[2].shape[0] > T and psa[5].shape[0] >= E
    assert pda[10].shape[1] >= Q and pda[11].shape[1] > K
    assert (pda[0].shape[0] > da[0].shape[0]) == segment

    # Demod: PBCH symbols (C, Q), the sync TP, SP, NP, blank NP (C, K),
    # the latest pair's CE (C, 62); the raw CE rows (C, R, P).
    _same(pdemod[0][:, :Q], demod[0])
    for got, want in zip(pdemod[1:5], demod[1:5]):
        _same(got[:, :K], want)
    _same(pdemod[5], demod[5])
    _same(pce[:, :R], ce)
    # Stats: FOE/TOE lanes (T,), emit rows (E,), AC sums (C + 1: row C is
    # the pad segment), carry rows, ac_td correlations; the new history.
    for got, want in zip(pstats[:4], stats[:4]):
        _same(got[:T], want)
    for got, want in zip(pstats[4:6], stats[4:6]):
        _same(got[:E], want)
    for got, want in zip(pstats[6:8], stats[6:8]):
        _same(got[:C], want[:C])
    for got, want in zip(pstats[8:], stats[8:]):
        _same(got, want)
    _same(phist, hist)


def test_sync_measurement_rows_are_independent():
    """The sync measurements of one PSS/SSS pair have the same float32
    bits alone and among other pairs (the smoother is not a matrix
    product, whose kernel the row count picks): padded pairs cannot move a
    real pair's bits below the float16 packing either."""
    from lte_cell_scanner_tpu_torch.tracker import batch_frontend as bf

    rng = np.random.default_rng(41)
    pss, sss = (torch.from_numpy(rng.standard_normal((6, 72, 2)).astype(
        np.float32)) for _ in range(2))
    pss_conj = torch.from_numpy(rng.standard_normal((62, 2)).astype(
        np.float32))
    sss_seq = torch.from_numpy(rng.choice([-1.0, 1.0], (6, 62)).astype(
        np.float32))
    full = bf.sync_meas_batch(pss, sss, pss_conj, sss_seq)
    for i in range(6):
        one = bf.sync_meas_batch(pss[i:i + 1], sss[i:i + 1], pss_conj,
                                 sss_seq[i:i + 1])
        for k, v in full.items():
            _same(one[k][0], v[i])


# ---------------------------------------------------------------------------
# On the card.


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _track(dev, seed: int, blocks: int):
    """The benchmark's one-cell site (traffic site1) tracked as its cell
    runs it: kalibrate, two chunks of 200 blocks to acquire, then
    ``blocks`` blocks with the tracer on. Returns (tracker, blocks run,
    the tracer's counts over those blocks)."""
    from benchmark.sim.playback import playback
    from benchmark.sim.site import draw_site
    from lte_cell_scanner_tpu_torch.tracker.runtime import LTETracker
    from lte_cell_scanner_tpu_torch.utils.profiling import TRACER

    spec = json.loads((ROOT / "benchmark" / "traffic" / "site1.json")
                      .read_text())["site"]
    site = draw_site(spec, seed)
    trk = LTETracker(739e6, engine_every=1, feeder="python", device=dev)
    trk.kalibrate(playback(site.recording, site.noise_power, [seed, 1]),
                  ppm=10)
    src = playback(site.recording, site.noise_power, [seed, 2])
    for _ in range(2):
        trk.run(src, max_blocks=200)
    torch.cuda.synchronize(dev)
    TRACER.reset()
    TRACER.enable()
    try:
        n = trk.run(src, max_blocks=blocks)
        counts = dict(TRACER.snapshot()["counts"])
    finally:
        TRACER.disable()
        TRACER.reset()
    return trk, n, counts


@pytest.mark.card
def test_graph_replay_is_invisible(card, monkeypatch):
    seed, blocks = 2305843013, 300
    graphs, n, counts = _track(card, seed, blocks)
    assert n == blocks
    assert counts.get("engine.graph_replays", 0) >= 2 * n
    # On graphs a program runs eagerly only on its bucket's first cycle.
    assert counts.get("engine.eager_programs", 0) == counts.get(
        "engine.graph_captures", 0)

    monkeypatch.setattr(br._GraphCache, "entry", lambda self, *a: None)
    eager, n_e, counts_e = _track(card, seed, blocks)
    assert n_e == blocks and "engine.graph_replays" not in counts_e
    assert counts_e["engine.eager_programs"] >= 2 * n_e

    assert graphs.state.frequency_offset == eager.state.frequency_offset
    assert len(graphs.cells) == len(eager.cells) >= 1
    for g, e in zip(graphs.cells, eager.cells):
        assert (g.n_id_cell, g.mib_decode_successes,
                g.mib_decode_failures) == (e.n_id_cell,
                                           e.mib_decode_successes,
                                           e.mib_decode_failures)
        assert g.mib_decode_successes > 0
        assert g.frame_timing == e.frame_timing
        for name in ("ac_fd", "ac_td"):
            _same(getattr(g, name), getattr(e, name))
    for trk in (graphs, eager):
        staging = trk.engine._staging
        assert isinstance(staging, PinnedStaging)
        assert all(b is not None and b.is_pinned() for b in staging.bufs)
