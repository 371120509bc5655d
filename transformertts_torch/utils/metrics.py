"""Attention-map quality metrics, the counterpart of
``transformertts_tpu/utils/metrics.py``, in torch ops on the maps' device.

Per head: jumpiness (how monotonic the argmax path is), peakiness (mean max
attention) and diagonality (attention mass weighted by the normalized
distance from the diagonal). Duration extraction scores heads with them; the
diagonal mask is also the Aligner's diagonal-forcing training penalty.
"""
from typing import Tuple

import torch


def attention_jumps_score(att: torch.Tensor, mel_len: torch.Tensor,
                          r: int = 1) -> torch.Tensor:
    """Fraction of consecutive argmax steps whose |move| is ≤ r.

    The difference is taken absolute, as in the reference, so the ``>= 0``
    term is vacuous and a backward move of ≤ r scores as a forward one; head
    selection in duration extraction depends on this exact formula.

    att: (B, H, M, N); mel_len: (B,). Returns (B, H) float32.
    """
    max_loc = torch.argmax(att, dim=3)                            # (B, H, M)
    diff = (max_loc[:, :, 1:] - max_loc[:, :, :-1]).abs()
    ok = ((diff >= 0) & (diff <= r)).float()
    m = torch.arange(1, att.shape[2], device=att.device)[None, None, :] < mel_len[:, None, None]
    ok = ok * m.float()
    return ok.sum(dim=-1) / torch.clamp_min((mel_len - 1).float(), 1.0)[:, None]


def attention_peak_score(att: torch.Tensor, mel_len: torch.Tensor) -> torch.Tensor:
    """Mean (over frames) of the per-frame max attention. Returns (B, H)."""
    peak = att.amax(dim=3)                                        # (B, H, M)
    m = (torch.arange(att.shape[2], device=att.device)[None, None, :]
         < mel_len[:, None, None]).float()
    return (peak * m).mean(dim=-1)


def batch_diagonal_mask(att_shape: Tuple[int, ...], mel_len: torch.Tensor,
                        phon_len: torch.Tensor) -> torch.Tensor:
    """Normalized distance from the diagonal, (B, 1, M, N) float32:
    |n / phon_len[b] − m / mel_len[b]| inside the valid (mel_len[b],
    phon_len[b]) rectangle, 0 outside. Lengths are clamped to at least 1, so
    an all-padding sample gives an all-zero mask, not NaN."""
    _, _, m_size, n_size = att_shape
    device = mel_len.device
    mel_c = torch.clamp(mel_len, 1, m_size).float()[:, None, None]      # (B, 1, 1)
    phon_c = torch.clamp(phon_len, 1, n_size).float()[:, None, None]
    m_idx = torch.arange(m_size, dtype=torch.float32, device=device)[None, :, None]
    n_idx = torch.arange(n_size, dtype=torch.float32, device=device)[None, None, :]
    valid = ((m_idx < mel_c) & (n_idx < phon_c)).float()
    return ((n_idx / phon_c - m_idx / mel_c).abs() * valid)[:, None, :, :]


def diagonality_score(att: torch.Tensor, mel_len: torch.Tensor, phon_len: torch.Tensor,
                      diag_mask: torch.Tensor = None) -> torch.Tensor:
    """Attention mass weighted by the distance from the diagonal. (B, H)."""
    if diag_mask is None:
        diag_mask = batch_diagonal_mask(att.shape, mel_len, phon_len)
    return (att * diag_mask).sum(dim=(-2, -1))


def attention_score(att: torch.Tensor, mel_len: torch.Tensor, phon_len: torch.Tensor,
                    r: int = 1) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(jumpiness, peakiness, 3 / diagonality) per (sample, head); higher is
    better for each. An all-padding sample's diagonality is floored at 1e-8
    so the score stays finite."""
    loc = attention_jumps_score(att, mel_len, r)
    peak = attention_peak_score(att, mel_len)
    diag = diagonality_score(att, mel_len, phon_len)
    return loc, peak, 3.0 / torch.clamp_min(diag, 1e-8)
