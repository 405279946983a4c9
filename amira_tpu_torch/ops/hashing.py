"""Vectorized gene-mer hashing and canonicalization in torch int64.

Port of `amira_tpu/ops/hashing.py` (same semantics, bit for bit): a gene-mer
is a window of k stranded genes; its reverse complement is the reversed
window with strands flipped; the canonical form is the lexicographically
smaller of the two per-gene signed hash sequences, and the node identity is
a splitmix64 chain over the canonical sequence seeded with k.

torch has no unsigned 64-bit shift, compare or minimum, so every value here
is an int64 holding the uint64 bit pattern:

* multiplies and adds wrap modulo 2^64 exactly as uint64 ones do;
* a logical right shift is `(x >> s) & ((1 << (64 - s)) - 1)`;
* the canonical-orientation choice compares SIGNED per-gene hashes
  (`hashing.py:92-97` of the JAX package), which int64 does natively.

Callers hand results to NumPy as `.numpy().view(np.uint64)`, where node
grouping sorts them as unsigned values.
"""

from __future__ import annotations

import torch


def _signed(u: int) -> int:
    """The int64 value with the bit pattern of uint64 `u`."""
    return u - (1 << 64) if u >= (1 << 63) else u


_GOLDEN = _signed(0x9E3779B97F4A7C15)
_MIX1 = _signed(0xBF58476D1CE4E5B9)
_MIX2 = _signed(0x94D049BB133111EB)


def _srl(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def splitmix64(x: torch.Tensor) -> torch.Tensor:
    """splitmix64 finalizer over int64 tensors holding uint64 bit patterns."""
    x = x * _GOLDEN + 1
    x = (x ^ _srl(x, 30)) * _MIX1
    x = (x ^ _srl(x, 27)) * _MIX2
    return x ^ _srl(x, 31)


def gene_hash(tokens: torch.Tensor) -> torch.Tensor:
    """Signed 63-bit hash per signed gene token; h(+g) = -h(-g), 0 -> 0."""
    tokens = tokens.to(torch.int64)
    h = _srl(splitmix64(tokens.abs()), 1)  # 63-bit positive
    return torch.sign(tokens) * h


def _combine_hash_seq(seq_hashes: torch.Tensor) -> torch.Tensor:
    """Collapse a (..., k) int64 hash sequence into one hash per window: a
    splitmix64 chain seeded with k."""
    k = seq_hashes.shape[-1]
    acc = torch.full(seq_hashes.shape[:-1], k, dtype=torch.int64, device=seq_hashes.device)
    for j in range(k):
        acc = splitmix64(acc ^ seq_hashes[..., j].to(torch.int64))
    return acc


def _canonical_windows(fwd: torch.Tensor, k: int):
    """(..., k) signed hash windows -> (node hash int64, direction int8)."""
    rc = -fwd.flip(-1)
    diff = (fwd != rc).to(torch.uint8)
    # first differing index (0 if none): argmax returns the first maximum
    first = diff.argmax(dim=-1, keepdim=True)
    fwd_at = fwd.gather(-1, first)[..., 0]
    rc_at = rc.gather(-1, first)[..., 0]
    fwd_is_canon = fwd_at <= rc_at  # ties (self-RC) impossible for odd k
    canon = torch.where(fwd_is_canon[..., None], fwd, rc)
    direction = torch.where(fwd_is_canon, 1, -1).to(torch.int8)
    return _combine_hash_seq(canon), direction


def genemer_windows(tokens, lengths, k: int):
    """Canonicalized gene-mers for a padded read batch.

    tokens (R, L) signed gene tokens, 0-padded; lengths (R,). Returns a dict
    of (R, L - k + 1) tensors: node_hash int64 (uint64 bits), direction int8
    (+1 if the observed orientation is canonical), valid bool.
    """
    tokens = torch.as_tensor(tokens)
    lengths = torch.as_tensor(lengths, device=tokens.device)
    R, L = tokens.shape
    W = L - k + 1
    if W <= 0:
        z = torch.zeros((R, 0), device=tokens.device)
        return {
            "node_hash": z.to(torch.int64),
            "direction": z.to(torch.int8),
            "valid": z.to(torch.bool),
        }
    h = gene_hash(tokens)
    fwd = torch.stack([h[:, j : j + W] for j in range(k)], dim=-1)  # (R, W, k)
    node_hash, direction = _canonical_windows(fwd, k)
    widx = torch.arange(W, device=tokens.device)[None, :]
    valid = widx < (lengths[:, None].to(torch.int64) - (k - 1))
    return {"node_hash": node_hash, "direction": direction, "valid": valid}


def edge_key(src_hash, src_dir, tgt_hash, tgt_dir):
    """Canonical edge identity (Edge.__hash__ semantics): the key of
    (s, d_s) -> (t, d_t) equals that of (s, -d_s) -> (t, -d_t)."""
    a = src_hash.to(torch.int64) * src_dir.to(torch.int64)
    b = tgt_hash.to(torch.int64) * tgt_dir.to(torch.int64)
    na, nb = -a, -b
    take_neg = (na < a) | ((na == a) & (nb < b))
    ca = torch.where(take_neg, na, a)
    cb = torch.where(take_neg, nb, b)
    acc = splitmix64(ca ^ 2)
    return splitmix64(acc ^ cb)


def node_hash_from_signed_seq(seq) -> int:
    """Canonical node hash of one gene-mer of signed tokens, as a Python int
    holding the uint64 value (host-side helper; runs on the CPU)."""
    seq = torch.as_tensor(seq, dtype=torch.int32)[None, :]
    k = seq.shape[1]
    out = genemer_windows(seq, torch.tensor([k], dtype=torch.int32), k)
    return int(out["node_hash"][0, 0]) % (1 << 64)
