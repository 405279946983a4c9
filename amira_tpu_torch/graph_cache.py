"""Incremental graph-build cache.

The cleaning pipeline rebuilds the gene-mer graph dozens of times on read
sets that change only marginally between iterations (SURVEY §3.3; reference
amira/graph_utils.py:127-181 rebuilds from scratch each time). The cache
keeps, per (k, read):

  * the device-computed canonical window hash / direction vectors,
  * the tokenized read,
  * ready-to-copy per-read Python table rows (node list, direction list,
    windowed gene positions).

A rebuild then only dispatches device kernels for reads whose gene
annotation actually changed (typically a few percent per cleaning
iteration), and the global node/edge/coverage tables are re-aggregated from
the cached occurrence vectors with vectorized host group-bys (np.unique)
instead of a full device round trip per iteration — the per-window hashing
stays on the accelerator, the incremental merge bookkeeping stays on the
host.

Entries are validated by comparing a snapshot of the gene list (and, for
positions, the identity of the position list object — corrected reads always
receive fresh list objects, see amira_tpu/correct.py), so a stale hit is
impossible as long as callers never mutate a read's gene list in place.
"""

from __future__ import annotations

import numpy as np


class CacheEntry:
    __slots__ = (
        "genes",  # snapshot copy of the stranded gene strings
        "genes_src",  # the gene-list object last validated against (identity
        #               fast path; in-place mutation of a read's gene list is
        #               unsupported, see module docstring)
        "tok",  # np.int32 (L,) signed gene tokens
        "wh",  # np.uint64 (W,) canonical window hashes
        "wd",  # np.int8  (W,) window directions (+1/-1)
        "nodes_tpl",  # list[int] template for _readNodes rows (lazy)
        "dirs_tpl",  # list[int] template for _readNodeDirections rows (lazy)
        "pos_src",  # the gene-position list object the template was cut from
        "pos_tpl",  # list[tuple] — template for _readNodePositions rows
    )

    def nodes_list(self):
        """_readNodes row template (window hashes as Python ints), built on
        first use — most cache entries never need it in the tensor loop."""
        if self.nodes_tpl is None:
            self.nodes_tpl = self.wh.tolist()
        return self.nodes_tpl

    def dirs_list(self):
        if self.dirs_tpl is None:
            self.dirs_tpl = self.wd.tolist()
        return self.dirs_tpl


class GraphBuildCache:
    """Per-(k, read_id) cache of device window computations.

    One instance lives for a pipeline run and is shared by every
    GeneMerGraph the run constructs (all k values).
    """

    def __init__(self, device):
        # torch device of the large window-hashing passes of every build
        # that shares this cache (graph.GeneMerGraph._compute_cache_misses)
        self.device = device
        self._by_k: dict[int, dict[str, CacheEntry]] = {}
        self.hits = 0
        self.misses = 0
        self.vocab = None  # the GeneVocab all cached tokens were produced by
        # per-k concatenated occurrence streams of the LAST build (entry
        # list + occ/wd_cat/wlens/offs arrays), spliced instead of
        # re-concatenated when only a few reads changed
        self.streams: dict[int, dict] = {}

    def bind_vocab(self, vocab):
        """Pin the cache to the vocab of its first build; cached token/hash
        vectors are meaningless under any other vocab, so reuse with a
        different instance is an error rather than a silently wrong graph."""
        if self.vocab is None:
            self.vocab = vocab
        elif self.vocab is not vocab:
            raise ValueError(
                "GraphBuildCache was built with a different GeneVocab; pass "
                "the same vocab to every build that shares this cache (or "
                "use a fresh cache)."
            )

    def store(self, k: int) -> dict[str, CacheEntry]:
        return self._by_k.setdefault(int(k), {})

    def clear(self):
        self._by_k.clear()
        self.streams.clear()
        self.vocab = None
        # bubble-sweep sketch caches attached by bubbles.get_minhashes_for_
        # paths are keyed by read id / node hash: stale entries would serve
        # wrong sketches if the cache is rebound to a new read set
        for attr in ("node_sketches", "read_kmer_index"):
            self.__dict__.pop(attr, None)
