"""Phoneme durations from attention maps, the counterpart of
``transformertts_tpu/ops/duration_extraction.py``.

The cheapest monotonic path (moves right, down or down-right, cell cost
``max(attn) − attn``) from the top-left to the bottom-right of the
(mel × phoneme) attention grid; each mel row belongs to the last phoneme
column the path visits in it, and a phoneme's duration is its row count.

The path's distance table is a row-by-row dynamic program. The in-row
dependency ``d[j] = c[j] + min(e[j], d[j-1])`` unrolls to a prefix minimum,

    d[j] = a[j] + min_{k<=j} (e[k] − a[k−1]),   a = cumsum(c),
    e[k] = min(prev[k], prev[k−1]),

one ``torch.cummin`` a row on the tensor's device (``dist_table``), for a
whole batch at once. Backtracking, O(M + N) pointer chasing, runs on the
host. The native C++ DP (``transformertts_torch/native``) computes the same
path on the host, threaded over the batch; ``backend='auto'`` takes it where
it builds, as the JAX package does.
"""
from typing import List, Tuple

import numpy as np
import torch

from transformertts_torch.utils.metrics import attention_score
from transformertts_torch.utils.spectrogram_ops import mel_lengths, phoneme_lengths

BIG = 1e9


def dist_table(cost: torch.Tensor) -> torch.Tensor:
    """(..., M, N) cell costs → (..., M, N) float32 shortest monotonic path
    distances, on the tensor's device."""
    cost = cost.float()
    big = torch.full((*cost.shape[:-2], 1), BIG, device=cost.device)
    zero = torch.zeros_like(big)
    rows = [torch.cumsum(cost[..., 0, :], dim=-1)]   # row 0: right moves only
    for i in range(1, cost.shape[-2]):
        prev = rows[-1]
        e = torch.minimum(prev, torch.cat([big, prev[..., :-1]], dim=-1))
        a = torch.cumsum(cost[..., i, :], dim=-1)
        a_shift = torch.cat([zero, a[..., :-1]], dim=-1)
        rows.append(a + torch.cummin(e - a_shift, dim=-1).values)
    return torch.stack(rows, dim=-2)


def _backtrack_durations(dist: np.ndarray, m: int, n: int) -> np.ndarray:
    """Walk predecessors from (m-1, n-1) to (0, 0); count rows per column."""
    i, j = m - 1, n - 1
    # the path's column never decreases, so the last column it visits in a
    # row (the row's owner) is the FIRST one seen while backtracking
    last_col = np.full(m, -1, np.int64)
    last_col[i] = j
    while i > 0 or j > 0:
        up = dist[i - 1, j] if i > 0 else np.inf
        diag = dist[i - 1, j - 1] if (i > 0 and j > 0) else np.inf
        left = dist[i, j - 1] if j > 0 else np.inf
        best = np.argmin([diag, up, left])                # prefer diagonal on ties
        if best == 0:
            i, j = i - 1, j - 1
        elif best == 1:
            i = i - 1
        else:
            j = j - 1
        if last_col[i] < 0:
            last_col[i] = j
    durations = np.zeros(n, np.int64)
    for i in range(m):
        durations[last_col[i]] += 1
    return durations


def extract_durations_with_dp(attention_map) -> np.ndarray:
    """(mel M, phonemes N) attention → (N,) integer durations summing to M."""
    attention_map = np.asarray(attention_map, np.float32)
    cost = attention_map.max() - attention_map
    dist = dist_table(torch.as_tensor(cost)).numpy()
    return _backtrack_durations(dist, cost.shape[0], cost.shape[1])


def duration_to_alignment_matrix(durations: np.ndarray) -> np.ndarray:
    """(N,) durations → (N, Σdur) binary alignment, float64."""
    durations = np.asarray(durations, np.int64)
    ends = np.cumsum(durations)
    starts = ends - durations
    t = np.arange(int(durations.sum()))
    return ((t[None, :] >= starts[:, None])
            & (t[None, :] < ends[:, None])).astype(np.float64)


def resolve_backend(backend: str) -> str:
    """'native' or 'device': 'auto' takes the native DP where it builds."""
    if backend == 'auto':
        from transformertts_torch import native
        return 'native' if native.available() else 'device'
    if backend not in ('native', 'device'):
        raise ValueError(f"backend must be 'auto', 'native' or 'device', not {backend!r}")
    return backend


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def get_durations_from_alignment(batch_alignments, mels, phonemes, weighted: bool = False,
                                 backend: str = 'auto'
                                 ) -> Tuple[List[np.ndarray], List[np.ndarray],
                                            np.ndarray, np.ndarray, np.ndarray]:
    """Score the heads, pick or weight them, find each sample's path, and
    return (durations, final alignments, jumpiness, peakiness, diagonality).

    ``batch_alignments`` (B, H, M, N) is a tensor (the scores and the
    'device' distance tables are computed on its device) or a numpy array;
    ``mels`` (B, T, C) with their start and end vectors and ``phonemes``
    (B, N) give the lengths from their padding. The first mel frame (the
    start vector's prediction) and the first and last tokens (start, end)
    are dropped; heads are scored by jumpiness + peakiness + diagonality, and
    the score-weighted head sum (``weighted``) or the best head feeds the
    path search. ``backend``: 'native' (the C++ DP on the host), 'device'
    (``dist_table`` on the maps' device, backtracking on the host) or 'auto'.
    """
    att = torch.as_tensor(batch_alignments)
    maps = _host(att)
    mel_len = _host(mel_lengths(_host(mels), 0.0)) - 1
    phon_len = _host(phoneme_lengths(_host(phonemes))) - 1
    scores = attention_score(att, torch.as_tensor(mel_len, device=att.device),
                             torch.as_tensor(phon_len, device=att.device), r=1)
    jumpiness, peakiness, diag_measure = (_host(s) for s in scores)
    attn_scores = diag_measure + jumpiness + peakiness

    b, _, m_pad, n_pad = maps.shape
    costs = np.full((b, m_pad, n_pad), BIG, np.float32)
    dims = []
    for idx in range(b):
        # an all-padding sample degenerates to an empty grid and empty durations
        m = max(int(mel_len[idx]) - 1, 0)
        n = max(int(phon_len[idx]) - 1, 0)
        al = maps[idx][:, 1:1 + m, 1:1 + n]
        if weighted:
            ref = np.sum(al * attn_scores[idx][:, None, None], axis=0)
        else:
            ref = al[np.argmax(attn_scores[idx])]
        if m and n:
            costs[idx, :m, :n] = ref.max() - ref
        dims.append((m, n))

    if resolve_backend(backend) == 'native':
        from transformertts_torch import native
        native_durs = native.duration_dp_batch(costs, [max(m, 1) for m, _ in dims],
                                               [max(n, 1) for _, n in dims])
        dists = None
    else:
        dists = dist_table(torch.as_tensor(costs, device=att.device)).cpu().numpy()

    durations, final_alignment = [], []
    for idx in range(b):
        m, n = dims[idx]
        if m == 0 or n == 0:
            durations.append(np.zeros(n, np.int32))
            final_alignment.append(np.zeros((n, m)))
            continue
        if dists is None:
            dur = native_durs[idx, :n].astype(np.int64)
        else:
            dur = _backtrack_durations(dists[idx], m, n)
        assert dur.sum() == m, f'{dur.sum()} vs {m}'
        best_head = int(np.argmax(attn_scores[idx]))
        best_attention = maps[idx][best_head, 1:1 + m, 1:1 + n]
        final_alignment.append(best_attention.T + duration_to_alignment_matrix(dur))
        durations.append(dur.astype(np.int32))
    return durations, final_alignment, jumpiness, peakiness, diag_measure
