"""The PSS scan of one capture sharded over a (seq, hyp) mesh of devices.

Counterpart of lte_cell_scanner_tpu/parallel/sharded_search.py. The
reference is single-machine (OpenMP over correlation lags,
src/searcher.cpp:152-154); the scan has two axes to split:

- ``seq``: the 80 ms capture folds into n_comb_xc half-frame segments
  that are combined incoherently (src/searcher.cpp:263-308). Each shard
  takes a contiguous run of fold segments (its slice of the capture plus
  a halo for the 137-tap window and the k_factor drift), runs the scan
  kernel K1 (``xcorr_fold``) on it, and its partial fold sums are summed
  over the shards.
- ``hyp``: the frequency-hypothesis grid; each shard correlates its slice
  of the grid, and the slices are gathered in hypothesis order before the
  delay spread and the collapse.

In one process the partials are summed in a fixed shard order onto the
first shard's device, so that the result is deterministic. With
``torch.distributed`` initialized the mesh spans every process,
process-major along ``seq`` as the JAX mesh is: each process sums its own
shards' partials, then ``all_reduce`` runs over the ranks of a ``seq``
column and ``all_gather`` over the ranks of a ``hyp`` row.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from lte_cell_scanner_tpu_torch.constants import HALF_FRAME, PSS_TD_LEN
from lte_cell_scanner_tpu_torch.ops.xcorr import (XcorrResult,
                                                  fold_start_indices,
                                                  n_comb_sp_for,
                                                  shifted_templates)
from lte_cell_scanner_tpu_torch.ops.xcorr_torch import (_delay_spread,
                                                        win_sum, xcorr_fold)
from lte_cell_scanner_tpu_torch.utils.device import resolve_device

# Blocks start _LEFT_PAD samples before their first fold segment (fold
# positions drift by |k-1| * n_cap < ~16 samples at 100 ppm, in either
# direction) and extend far enough past the last segment for the 137-tap
# correlation window, the 274-sample power window, and the same drift.
_LEFT_PAD = 64
_RIGHT_PAD = 280


def _distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


class SearchMesh:
    """An (n_seq, n_hyp) grid of scan shards over the processes of a run.

    Shard (s, h) has the global index g = s n_hyp + h and belongs to rank
    g // n_local; this process holds its rank's n_local shards, on
    ``devices`` in order (devices may repeat). ``shape`` reads as the
    JAX mesh's. Each rank's shards are whole rows of the grid or a run of
    columns of one row, so that the ``seq`` and ``hyp`` groups of
    :func:`sharded_xcorr_pss`'s collectives are well defined."""

    def __init__(self, n_seq: int, n_hyp: int, devices: Sequence,
                 rank: int = 0, world: int = 1):
        n = n_seq * n_hyp
        if n % world or len(devices) != n // world:
            raise ValueError(f"search mesh {n_seq} x {n_hyp}: {world} "
                             f"process(es) hold {len(devices)} shard(s) "
                             "each; want the grid divided evenly")
        n_local = n // world
        if n_local % n_hyp and n_hyp % n_local:
            raise ValueError(f"search mesh {n_seq} x {n_hyp}: {n_local} "
                             "shards per process are neither whole rows "
                             "nor a part of one row")
        self.shape = {"seq": n_seq, "hyp": n_hyp}
        self.devices = tuple(resolve_device(d) for d in devices)
        self.rank, self.world = rank, world
        # (s, h, device) of this process's shards, in global order.
        self.local = [(g // n_hyp, g % n_hyp, dev) for g, dev in
                      zip(range(rank * n_local, (rank + 1) * n_local),
                          self.devices)]
        # Ranks per grid row: the size of a hyp group.
        self.row_ranks = max(1, n_hyp // n_local)
        self.seq_group = self.hyp_group = None
        if _distributed():
            # Every rank builds every group, in the same order.
            r = self.row_ranks
            for k in range(r):
                g = dist.new_group([q for q in range(world) if q % r == k])
                if rank % r == k:
                    self.seq_group = g
            for q in range(world // r):
                g = dist.new_group(list(range(q * r, (q + 1) * r)))
                if rank // r == q:
                    self.hyp_group = g


def make_search_mesh(n_seq: int, n_hyp: int = 1,
                     devices=None) -> SearchMesh:
    """An (n_seq, n_hyp) search mesh. ``devices`` are this process's
    shards (default: the first ones of the CUDA devices; raises when fewer
    are visible). With torch.distributed initialized, the grid spans every
    process, this one holding n_seq n_hyp / world_size shards."""
    rank, world = ((dist.get_rank(), dist.get_world_size())
                   if _distributed() else (0, 1))
    n_local = n_seq * n_hyp // world
    if devices is None:
        n_vis = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n_vis < n_local:
            raise RuntimeError(f"make_search_mesh: {n_local} CUDA "
                               f"device(s) per process asked for, {n_vis} "
                               "visible")
        devices = [torch.device("cuda", i) for i in range(n_local)]
    return SearchMesh(n_seq, n_hyp, devices, rank, world)


def _plan_blocks(n_cap: int, n_seq: int) -> Tuple[int, int, int]:
    """Split the fold segments across seq shards.

    Returns (n_comb_xc, combs_per_shard, block_len). Shard d covers fold
    segments [d*cps, (d+1)*cps) and needs capture samples
    [d*cps*9600, ... + cps*9600 + halo).
    """
    n_lags = n_cap - (PSS_TD_LEN - 1)
    n_comb_xc = (n_lags - 100) // HALF_FRAME
    cps = -(-n_comb_xc // n_seq)  # ceil: last shard may have fewer
    block_len = _LEFT_PAD + cps * HALF_FRAME + PSS_TD_LEN - 1 + _RIGHT_PAD
    return n_comb_xc, cps, block_len


def _shard_inputs(capbuf, f_search_set, fc_requested, fc_programmed,
                  fs_programmed, n_seq, n_hyp, dtype):
    """Host-side prep: per-shard capture blocks (n_seq, 2, block_len),
    the template planes (n_f, 3, 2, 137) of the scan kernel, fold offsets
    local to each block, and the masks of valid fold segments."""
    capbuf = np.asarray(capbuf)
    n_cap = capbuf.shape[0]
    n_comb_xc, cps, block_len = _plan_blocks(n_cap, n_seq)
    f_search_set = np.asarray(f_search_set, dtype=np.float64)
    n_f = len(f_search_set)
    if n_f % n_hyp:
        raise ValueError(f"n_f={n_f} must divide over n_hyp={n_hyp} shards")

    cap_ri = np.stack([capbuf.real, capbuf.imag]).astype(dtype)
    blocks = np.zeros((n_seq, 2, block_len), dtype=dtype)
    starts = fold_start_indices(f_search_set, n_comb_xc, fc_requested,
                                fc_programmed, fs_programmed)  # (n_f, n_comb)
    local_starts = np.zeros((n_seq, n_f, cps), dtype=np.int32)
    # Masks of valid fold segments per shard (the tail shard may pad).
    # The signal-power estimate folds its own count (n_comb_sp_for) — the
    # correlation count would average zero-padded windows past the
    # capture end and bias the detection threshold low.
    valid = np.zeros((n_seq, cps), dtype=dtype)
    n_sp_eff = min(n_comb_sp_for(n_cap), n_seq * cps)
    valid_sp = np.zeros((n_seq, cps), dtype=dtype)
    sp_off = np.zeros(n_seq, dtype=np.int64)
    for d in range(n_seq):
        base = max(0, d * cps * HALF_FRAME - _LEFT_PAD)
        sp_off[d] = d * cps * HALF_FRAME - base
        chunk = cap_ri[:, base: base + block_len]
        blocks[d, :, :chunk.shape[1]] = chunk
        for m in range(cps):
            g = d * cps + m
            if g < n_comb_xc:
                local_starts[d, :, m] = starts[:, g] - base
                valid[d, m] = 1.0
            if g < n_sp_eff:
                valid_sp[d, m] = 1.0
    if (local_starts < 0).any():
        raise ValueError("halo too small for this ppm range")
    tpl = shifted_templates(f_search_set, fc_requested, fc_programmed,
                            fs_programmed)                   # (n_f, 3, 137)
    planes = np.stack([tpl.real, tpl.imag], axis=2).astype(dtype)
    return (blocks, local_starts, valid, valid_sp, sp_off, planes,
            n_comb_xc, n_sp_eff)


def _shard_partials(block, tpl, local_starts, n_valid, valid_sp, sp_off):
    """One shard's partial sums on its device: the fold sums of its
    n_valid fold segments (3, 9600, n_f_local), by K1 (which returns
    their mean), and its segments' 274-window signal power (9600,). A
    shard with no valid segment launches nothing and adds zeros."""
    n_f = tpl.shape[0]
    if n_valid:
        fold = xcorr_fold(block, tpl, local_starts[:, :n_valid].contiguous(),
                          n_valid) * n_valid
    else:
        fold = block.new_zeros((3, HALF_FRAME, n_f))
    cps = valid_sp.shape[0]
    pw = block[0] ** 2 + block[1] ** 2
    sp = (win_sum(pw, 2 * PSS_TD_LEN) / 274.0)[sp_off:sp_off
                                                + cps * HALF_FRAME]
    sp = (sp.view(cps, HALF_FRAME) * valid_sp[:, None]).sum(0)
    return fold, sp


def sharded_xcorr_pss(capbuf, f_search_set, ds_comb_arm, fc_requested,
                      fc_programmed, fs_programmed, mesh: SearchMesh,
                      dtype=np.float32) -> XcorrResult:
    """Run the PSS scan of one capture sharded over ``mesh``'s (seq, hyp)
    axes; returns the host tables of the unsharded scan. ``dtype``:
    float32 (the scan kernel's on the card) or float64 (the plain version
    on CPU shards)."""
    n_seq, n_hyp = mesh.shape["seq"], mesh.shape["hyp"]
    (blocks, local_starts, valid, valid_sp, sp_off, tpl, n_comb_xc,
     n_sp_eff) = _shard_inputs(capbuf, f_search_set, fc_requested,
                               fc_programmed, fs_programmed, n_seq, n_hyp,
                               dtype)
    n_f_l = tpl.shape[0] // n_hyp
    parts = {}
    for s, h, dev in mesh.local:            # dispatch every shard
        hs = slice(h * n_f_l, (h + 1) * n_f_l)
        parts[s, h] = _shard_partials(
            torch.from_numpy(blocks[s]).to(dev),
            torch.from_numpy(tpl[hs]).to(dev),
            torch.from_numpy(local_starts[s, hs]).to(dev),
            int(valid[s].sum()), torch.from_numpy(valid_sp[s]).to(dev),
            int(sp_off[s]))
    if _distributed():
        single, sp = _combine_distributed(parts, mesh)
    else:
        single, sp = _combine_local(parts, n_seq, n_hyp, mesh.devices[0])
    single = single / n_comb_xc
    inc = _delay_spread(single, ds_comb_arm)
    pow_ = inc.amax(dim=-1)
    frq = inc.argmax(dim=-1)

    def host(t):
        return t.cpu().numpy().astype(np.float64)

    return XcorrResult(
        xc_incoherent_collapsed_pow=host(pow_),
        xc_incoherent_collapsed_frq=frq.cpu().numpy().astype(np.int64),
        xc_incoherent_single=host(single),
        xc_incoherent=host(inc),
        sp_incoherent=np.roll(host(sp) / n_sp_eff, PSS_TD_LEN),
        n_comb_xc=int(n_comb_xc),
        n_comb_sp=int(n_sp_eff),
    )


def _combine_local(parts, n_seq, n_hyp, dev):
    """Every shard in this process: the sums over seq in shard order on
    ``dev``, the hyp slices concatenated in hypothesis order."""
    cols = []
    for h in range(n_hyp):
        acc = parts[0, h][0].to(dev)
        for s in range(1, n_seq):
            acc = acc + parts[s, h][0].to(dev)
        cols.append(acc)
    sp = parts[0, 0][1].to(dev)
    for s in range(1, n_seq):
        sp = sp + parts[s, 0][1].to(dev)
    return torch.cat(cols, dim=-1), sp


def _combine_distributed(parts, mesh: SearchMesh):
    """Across processes: this rank's partials summed over its rows (in
    order) for each of its columns, then one ``all_reduce`` over its seq
    group and one ``all_gather`` over its hyp group. The collectives run
    on the first shard's card (NCCL) or on the host (gloo)."""
    rows = sorted({s for s, _, _ in mesh.local})
    cols = sorted({h for _, h, _ in mesh.local})
    comm = (mesh.devices[0] if dist.get_backend() == "nccl"
            else torch.device("cpu"))
    col_sums: List[torch.Tensor] = []
    for h in cols:
        acc = parts[rows[0], h][0].to(comm)
        for s in rows[1:]:
            acc = acc + parts[s, h][0].to(comm)
        col_sums.append(acc)
    # The power is the same on every shard of a row: one per row.
    sp = parts[rows[0], cols[0]][1].to(comm)
    for s in rows[1:]:
        sp = sp + parts[s, cols[0]][1].to(comm)
    local = torch.cat(col_sums, dim=-1)
    buf = torch.cat([local.reshape(-1), sp])
    dist.all_reduce(buf, group=mesh.seq_group)
    local = buf[:-HALF_FRAME].view(local.shape)
    gathered = [torch.empty_like(local) for _ in range(mesh.row_ranks)]
    dist.all_gather(gathered, local, group=mesh.hyp_group)
    return torch.cat(gathered, dim=-1), buf[-HALF_FRAME:]
