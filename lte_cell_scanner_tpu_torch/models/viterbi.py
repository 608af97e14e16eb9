"""Batched exact-ML tail-biting Viterbi decoding of the LTE K=7 rate-1/3
code (the ``viterbi`` CUDA kernel) and its plain PyTorch version.

Counterpart of lte_cell_scanner_tpu/models/viterbi_pallas.py (reference
trellis: src/lte_lib.cpp:520-551 via IT++ decode_tailbite). Four trellis
steps are fused per pass (models/convcode.py::chain_tables):

  adds[p]   = sum_{k=0..11} A[k, p] * llr[t, k]   (p = s*16 + j, k in order)
  joint:      m[ss, s] = max_j m[ss, pred(s, j)] + adds[s*16 + j],
              pred(s, j) = ((s << 4) & 63) | j, m = 0 on the diagonal at t=0
  start     = first argmax_ss m[ss, ss]
  replay:     m1[s], bp[t, s] = max / first argmax_j from the start alone
  traceback:  j = bp[t, state]; bits = BITS[state, j];
              state = ((state << 4) & 63) | j

The kernel and the plain version add the branch sums in the same order
and break every tie to the first index, so their bits are identical.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from lte_cell_scanner_tpu_torch.kernels import LAUNCHES
from lte_cell_scanner_tpu_torch.kernels.build import check_launch, launcher
from lte_cell_scanner_tpu_torch.models.convcode import N_STATES, chain_tables
from lte_cell_scanner_tpu_torch.utils.device import launch_device

_K = 4
_JK = 2 ** _K          # chains per fused step


def sign_mask(A: np.ndarray) -> np.ndarray:
    """(12, 1024) +-1 -> (1024,) i32 whose bit k is set where A[k, p] is
    -1: the kernel's sign table (A * l is l with that sign bit flipped)."""
    return ((A < 0).astype(np.int64)
            << np.arange(A.shape[0])[:, None]).sum(axis=0).astype(np.int32)


@functools.lru_cache(maxsize=4)
def _tables(device: torch.device):
    """On ``device``: A (12, 1024) f32 of +-1, BITS (1024, 4) i32, the
    predecessor table pred[s, j] = ((s << 4) & 63) | j (64, 16) i64 and
    A's sign mask (1024,) i32."""
    A, BITS = chain_tables(_K)
    s = np.arange(N_STATES)[:, None]
    pred = ((s & 3) << 4) | np.arange(_JK)[None, :]
    return (torch.from_numpy(np.ascontiguousarray(A, np.float32)).to(device),
            torch.from_numpy(np.ascontiguousarray(
                BITS.reshape(N_STATES * _JK, _K), np.int32)).to(device),
            torch.from_numpy(pred).to(device),
            torch.from_numpy(sign_mask(A)).to(device))


def branch_sums(llr_tl: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """(n_steps, 12, L) -> (n_steps, L, 64, 16) branch sums, added in
    the row order k = 0..11."""
    acc = A[0][None, :, None] * llr_tl[:, 0, None, :]
    for k in range(1, A.shape[0]):
        acc = acc + A[k][None, :, None] * llr_tl[:, k, None, :]
    return acc.permute(0, 2, 1).reshape(
        llr_tl.shape[0], llr_tl.shape[2], N_STATES, _JK)


def viterbi_metrics_plain(llr_tl: torch.Tensor):
    """Joint-pass metrics of the plain decoder: (final (L, 64, 64) as
    [start, state], adds (n_steps, L, 64, 16)). chip_smoke.py reads the
    winner-vs-runner-up gap of the diagonal from it."""
    A, _, pred, _ = _tables(llr_tl.device)
    adds = branch_sums(llr_tl, A)
    L = llr_tl.shape[2]
    m = torch.full((L, N_STATES, N_STATES), float("-inf"),
                   dtype=torch.float32, device=llr_tl.device)
    m.diagonal(dim1=1, dim2=2).fill_(0.0)
    for t in range(llr_tl.shape[0]):
        m = (m[:, :, pred] + adds[t][:, None]).amax(dim=-1)
    return m, adds


def viterbi_tl_plain(llr_tl: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the ``viterbi`` kernel (same contract)."""
    n_steps, _, L = llr_tl.shape
    dev = llr_tl.device
    _, bits_tab, pred, _ = _tables(dev)
    m, adds = viterbi_metrics_plain(llr_tl)
    start = torch.argmax(torch.diagonal(m, dim1=1, dim2=2), dim=1)  # (L,)
    m1 = torch.full((L, N_STATES), float("-inf"), dtype=torch.float32,
                    device=dev)
    m1[torch.arange(L, device=dev), start] = 0.0
    bps = []
    for t in range(n_steps):
        cand = m1[:, pred] + adds[t]                        # (L, 64, 16)
        bps.append(torch.argmax(cand, dim=-1))
        m1 = cand.amax(dim=-1)
    out = torch.empty((_K * n_steps, L), dtype=torch.float32, device=dev)
    state = start
    for t in range(n_steps - 1, -1, -1):
        j = torch.gather(bps[t], 1, state[:, None])[:, 0]
        out[_K * t:_K * t + _K] = bits_tab[state * _JK + j].T.to(
            torch.float32)
        state = ((state << _K) & (N_STATES - 1)) | j
    return out


def viterbi_tl(llr_tl: torch.Tensor) -> torch.Tensor:
    """Decode L codewords from time-major LLRs.

    llr_tl (n_steps, 12, L) f32: row ti*3 + coded_bit of each 4-step
    chunk, ln(P0/P1). Returns bits (4*n_steps, L) f32. A CPU tensor takes
    the plain version; a CUDA tensor launches the kernel.
    """
    if llr_tl.device.type == "cpu":
        return viterbi_tl_plain(llr_tl)
    if llr_tl.dtype != torch.float32 or llr_tl.dim() != 3 \
            or llr_tl.shape[1] != 3 * _K or not llr_tl.is_contiguous() \
            or not 1 <= llr_tl.shape[0] <= 32:
        raise ValueError("viterbi_tl: want contiguous f32 (n_steps <= 32, "
                         f"12, L), got {llr_tl.dtype} {tuple(llr_tl.shape)}")
    n_steps, _, L = llr_tl.shape
    _, bits_tab, _, mask = _tables(llr_tl.device)
    out = torch.empty((_K * n_steps, L), dtype=torch.float32,
                      device=llr_tl.device)
    if L == 0:
        return out
    with launch_device(llr_tl.device):
        code = launcher("viterbi")(
            llr_tl.data_ptr(), n_steps, L, mask.data_ptr(),
            bits_tab.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(llr_tl.device).cuda_stream)
    check_launch("viterbi", code)
    LAUNCHES["viterbi"] += 1
    return out


def lte_conv_decode_batch(d_llr: torch.Tensor) -> torch.Tensor:
    """(B, 3, n) LLRs ln(P0/P1) -> (B, n) int64 bits; n a multiple of 4.
    The (B, 3, n) entry of the Pallas decoder."""
    B, three, n = d_llr.shape
    if three != 3 or n % _K:
        raise ValueError(f"lte_conv_decode_batch: bad shape {tuple(d_llr.shape)}")
    llr = d_llr.to(torch.float32).transpose(1, 2).reshape(B, n // _K, 3 * _K)
    bits = viterbi_tl(llr.permute(1, 2, 0).contiguous())
    return bits.T.to(torch.int64)
