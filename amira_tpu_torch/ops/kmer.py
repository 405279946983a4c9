"""Canonical DNA k-mer counting, histogramming and querying.

Port of `amira_tpu/ops/kmer.py`, the replacement for the reference's
Jellyfish subprocesses (result_utils.py:1050-1141: `jellyfish count -m 15
-C`, `histo`, `query`). The device and the size of the read set pick the
counter (`counter_for`):

* sorted, on cuda below 2^24 codes: every window's canonical code,
  computed in torch from the native 2-bit packer's one buffer, is sorted on
  the device; run starts and lengths give the (distinct k-mer, count)
  table, and only that table comes back to the host (uint32 k-mers, int64
  counts, the dtypes of JAX's sorted route).
* dense, on cuda from 2^24 codes: a (4^k + 1)-bin int32 count table in
  device memory (4 GiB at k = 15), filled by `index_add_` of the window
  codes of the packer's chunks; histogram, cutoff filter and per-path
  median queries run on the table in torch as well.
* host, on cpu at every size: the host NumPy counter, carried over
  unchanged (chunked canonical codes, per-chunk unique tables merged by
  sorted run-length sum, or a dense bincount for gigabase inputs).

All three give identical counts, histograms and medians (the sorted and
dense paths also run on CPU tensors, which the tests use); the sorted and
host tables answer histograms and queries on the host. The copy-number math
(Poisson-mixture error cutoff, smoothed histogram peak) is ported from
result_utils.py:975-1022.
"""

from __future__ import annotations

import numpy as np
import torch

from ..sketch import encode_dna

_SENTINEL = np.uint8(255)


def _concat_codes(seqs: list[str]) -> np.ndarray:
    """Concatenate 2-bit base codes with sentinel separators so k-mer windows
    never span two sequences. One C-speed join + LUT pass — the per-read
    append/concatenate loop cost tens of seconds on gigabase read sets."""
    seqs = list(seqs)
    if not seqs:
        return np.zeros(0, dtype=np.uint8)
    # "\n" is not ACGT, so the LUT maps it to the 255 sentinel
    return encode_dna("\n".join(seqs) + "\n")


def _host_canonical_codes(codes: np.ndarray, k: int) -> np.ndarray:
    """Valid canonical window codes, vectorized numpy (invalid windows
    dropped).

    Window codes are built by length doubling — f_{w+v}[i] = f_w[i] << 2v
    | f_v[i+w] — so k=15 takes ~7 O(N) passes instead of 15 (this runs
    over the ENTIRE read set for copy-number estimation)."""
    n = len(codes) - k + 1
    if n <= 0:
        return np.zeros(0, dtype=np.uint32)
    bad = codes >= 4
    cs = np.zeros(len(codes) + 1, np.int64)
    np.cumsum(bad, out=cs[1:])
    valid = (cs[k:] - cs[:-k]) == 0
    cc = np.where(bad, 0, codes).astype(np.uint32)
    rc1 = (np.uint32(3) - cc) & np.uint32(3)

    def window_codes(base):
        # powers[p] = codes of windows of length 2^p (truncated arrays)
        pw, plen = [base], [1]
        while plen[-1] * 2 <= k:
            w = plen[-1]
            prev = pw[-1]
            pw.append((prev[: len(prev) - w] << np.uint32(2 * w)) | prev[w:])
            plen.append(2 * w)
        acc, alen = None, 0
        for p in range(len(pw) - 1, -1, -1):
            if alen + plen[p] <= k:
                piece = pw[p]
                if acc is None:
                    acc, alen = piece, plen[p]
                else:
                    acc = (
                        acc[: len(acc) - plen[p]] << np.uint32(2 * plen[p])
                    ) | piece[alen:]
                    alen += plen[p]
        return acc[:n]

    fwd = window_codes(cc)
    # rc code of window [i, i+k): sum_j (3-c[i+j]) << 2j = the forward
    # composition of rc1 with the shift roles swapped — compute via the
    # same doubling on rc1 but composing in reversed significance
    rcp, rlen = [rc1], [1]
    while rlen[-1] * 2 <= k:
        w = rlen[-1]
        prev = rcp[-1]
        # reversed significance: later positions take HIGHER bits
        rcp.append(prev[: len(prev) - w] | (prev[w:] << np.uint32(2 * w)))
        rlen.append(2 * w)
    acc, alen = None, 0
    for p in range(len(rcp) - 1, -1, -1):
        if alen + rlen[p] <= k:
            piece = rcp[p]
            if acc is None:
                acc, alen = piece, rlen[p]
            else:
                acc = acc[: len(acc) - rlen[p]] | (
                    piece[alen:] << np.uint32(2 * alen)
                )
                alen += rlen[p]
    rc = acc[:n]
    return np.minimum(fwd, rc)[valid]


_HOST_COUNT_CHUNK = 1 << 27
# above this many codes the dense-bincount counter (8 GB table for k=15)
# pays for itself vs per-chunk sorting
_HOST_BINCOUNT_MIN = 1 << 28

# below this many codes cuda sorts (above it the dense table): the JAX
# package's edge (amira_tpu/ops/kmer.py:341-342), kept for parity; where
# the sorted and dense counters cross over on the card is not measured
_SORTED_CUDA_LIMIT = 1 << 24

# sorted tables made, by device type (a run can show which counter served it)
SORTED_TABLES = {"cpu": 0, "cuda": 0}


def counter_for(device_type: str, n_codes: int) -> str:
    """The counter `KmerCounter.from_sequences` takes for a read set of
    `n_codes` codes (bases plus one separator a read) on a device of
    `device_type`: "sorted" or "dense" on cuda, "host" on cpu."""
    if device_type == "cuda":
        return "sorted" if n_codes < _SORTED_CUDA_LIMIT else "dense"
    return "host"


# ---------------------------------------------------- dense table counter
#
# The whole (4^k + 1)-bin int32 table stays where it was allocated (device
# memory on cuda): counting is one scatter-add per streamed chunk, the
# histogram a chunked bincount over the bin values, the cutoff refilter an
# in-place masked fill, per-path depth queries gathers. Bin 4^k collects
# invalid windows and is never queried. Counts stay far below 2^31.

_DENSE_CHUNK = 1 << 26  # codes per streamed chunk
_HISTO_CAP = 1 << 20  # count-histogram bins; counts past this resolve exactly

# dense tables allocated, by device type (a run can show where its
# copy-number table lived)
DENSE_TABLES = {"cpu": 0, "cuda": 0}


def _pack_codes_2bit(codes: np.ndarray):
    """Host: pack base codes 16-per-uint32 plus a little-endian invalid
    bitmask (separators / non-ACGT). Contiguous (N/16, 16) shift + reduce."""
    import sys as _sys

    assert _sys.byteorder == "little"
    bad = codes > 3
    # bad positions carry garbage 2-bit values; the bitmask invalidates
    # every window touching them, so masking the VALUE is unnecessary
    c = codes & np.uint8(3)
    pad = (-len(c)) % 16
    if pad:
        c = np.concatenate([c, np.zeros(pad, np.uint8)])
        bad = np.concatenate([bad, np.ones(pad, bool)])
    shifts8 = np.array([0, 2, 4, 6], np.uint8)
    by = np.bitwise_or.reduce(c.reshape(-1, 4) << shifts8[None, :], axis=1)
    words = by.astype(np.uint8).view(np.uint32)
    return words, np.packbits(bad, bitorder="little")


def _to_device_words(words_np: np.ndarray, bad_np: np.ndarray, device):
    """uint32 words / uint8 bitmask -> tensors on `device` (the words as
    int32 bit patterns: torch has no uint32 shifts). Read-only buffers (the
    native packer's bytes) are copied: torch wants writable arrays."""
    words = np.array(words_np, copy=not words_np.flags.writeable).view(np.int32)
    bad = np.array(bad_np, copy=not bad_np.flags.writeable)
    return torch.from_numpy(words).to(device), torch.from_numpy(bad).to(device)


def _pack_one_buffer(seqs: list, k: int):
    """All of `seqs` as one 2-bit buffer (uint32 words, invalid bitmask) of
    at least 2^12 codes, one invalid code after each read, the tail padded
    invalid: the native packer's chunk layout, or the same codes packed
    from the joined stream when the native helper is absent."""
    from ..native import load as _load_native

    n_codes = sum(len(s) for s in seqs) + len(seqs)
    n_pad = max(1 << 12, (n_codes + 15) // 16 * 16)
    native = _load_native()
    if native is not None and hasattr(native, "pack_dna_chunk"):
        wb, bb, idx, _off = native.pack_dna_chunk(seqs, 0, 0, n_pad, k)
        if idx != len(seqs):
            raise RuntimeError(f"pack_dna_chunk packed {idx} of {len(seqs)} reads into one buffer")
        return np.frombuffer(wb, np.uint32), np.frombuffer(bb, np.uint8)
    codes = _concat_codes(seqs)
    codes = np.concatenate([codes, np.full(n_pad - len(codes), _SENTINEL, np.uint8)])
    return _pack_codes_2bit(codes)


def _canonical_window_codes(words, bad_bytes, k: int):
    """Unpack 2-bit codes (16 per int32 word) and the invalid bitmask, and
    form the canonical code of every k-window; invalid windows -> 4^k."""
    dev = words.device
    shifts = torch.arange(0, 32, 2, dtype=torch.int32, device=dev)
    codes = ((words[:, None] >> shifts[None, :]) & 3).reshape(-1).to(torch.int64)
    bshift = torch.arange(8, dtype=torch.uint8, device=dev)
    bad = (((bad_bytes[:, None] >> bshift[None, :]) & 1) != 0).reshape(-1)
    n = codes.shape[0] - k + 1
    fwd = torch.zeros(n, dtype=torch.int64, device=dev)
    rc = torch.zeros(n, dtype=torch.int64, device=dev)
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    for j in range(k):
        bj = codes[j : j + n]
        valid &= ~bad[j : j + n]
        fwd = (fwd << 2) | bj
        rc |= (3 - bj) << (2 * j)
    return torch.where(valid, torch.minimum(fwd, rc), 4**k)


def _dense_count_chunk(table, words, bad, k: int):
    idx = _canonical_window_codes(words, bad, k)
    ones = torch.ones(idx.shape[0], dtype=torch.int32, device=table.device)
    table.index_add_(0, idx, ones)


def _dense_filter_(table, cutoff: int):
    """jellyfish-recount-with--L equivalent, in place: zero every bin below
    cutoff, and the invalid-window bin (it is never queried)."""
    table.masked_fill_(table < cutoff, 0)
    table[-1] = 0
    return table


def _dense_histo(table, cap: int) -> dict[int, int]:
    """count -> number of k-mers with that count over the dense table, in
    ascending count order. The bincount clips counts to cap - 1; counts
    >= cap are gathered exactly and replace the clipped lump."""
    bc = torch.zeros(cap, dtype=torch.int64, device=table.device)
    tails = []
    vals = table[:-1]
    for s in range(0, vals.shape[0], _DENSE_CHUNK):
        v = vals[s : s + _DENSE_CHUNK]
        v = v[v > 0]
        bc += torch.bincount(v.clamp(max=cap - 1).to(torch.int64), minlength=cap)
        tails.append(v[v >= cap])
    bc = bc.cpu().numpy()
    tail = torch.cat(tails).cpu().numpy()
    bc[cap - 1] -= len(tail)
    out = {int(v): int(bc[v]) for v in np.nonzero(bc)[0]}
    tail_vals, tail_counts = np.unique(tail, return_counts=True)
    for v, c in zip(tail_vals.tolist(), tail_counts.tolist()):
        out[v] = out.get(v, 0) + c
    return dict(sorted(out.items()))


def _dense_query_median2(table, words, bad, k: int):
    """(sum of the two middle counts, number of nonzero counts) over the
    table counts of every valid k-mer window of a packed query stream, zero
    counts dropped. Integers throughout: the caller halves the sum."""
    idx = _canonical_window_codes(words, bad, k)
    valid = idx < 4**k
    counts = torch.where(valid, table[torch.where(valid, idx, 0)], 0)
    nz = torch.sort(counts[counts != 0]).values
    n = nz.shape[0]
    if n == 0:
        return 0, 0
    return int(nz[(n - 1) // 2]) + int(nz[n // 2]), n


class KmerCounter:
    """Canonical k-mer count table over a read set (jellyfish equivalent)."""

    def __init__(self, k: int = 15):
        assert 2 * k <= 31, "k-mer must fit in an int32 code"
        self.k = k
        self.kmers: np.ndarray = np.zeros(0, dtype=np.uint32)
        self.counts: np.ndarray = np.zeros(0, dtype=np.int64)
        # dense mode: the whole (4^k + 1)-bin table as a torch tensor;
        # kmers/counts above stay empty (histo/query route through it)
        self.dense = None

    @classmethod
    def _from_seqs_dense(cls, seqs, k: int, min_count: int, device):
        """Dense counter fed by the native C packer: reads pack straight
        into fixed-size 2-bit chunk buffers (a read cut at a chunk end
        resumes k-1 codes earlier, and every inter-read gap carries an
        invalid sentinel), so the table equals the count over the joined
        stream."""
        from ..native import load as _load_native

        seqs = list(seqs)
        self = cls(k)
        table = torch.zeros(4**k + 1, dtype=torch.int32, device=device)
        DENSE_TABLES[table.device.type] += 1
        native = _load_native()
        if native is not None and hasattr(native, "pack_dna_chunk"):
            idx, off, n = 0, 0, len(seqs)
            while idx < n:
                words_b, bad_b, idx, off = native.pack_dna_chunk(
                    seqs, idx, off, _DENSE_CHUNK, k
                )
                words, bad = _to_device_words(
                    np.frombuffer(words_b, np.uint32),
                    np.frombuffer(bad_b, np.uint8),
                    device,
                )
                _dense_count_chunk(table, words, bad, k)
        else:
            cls._count_codes_dense(table, _concat_codes(seqs), k)
        if min_count > 0:
            _dense_filter_(table, min_count)
        self.dense = table
        return self

    @staticmethod
    def _count_codes_dense(table, codes: np.ndarray, k: int):
        """Chunk-streamed dense count of a joined code stream (the Python
        fallback of the native packer). Chunks split at separators so no
        window spans two chunks; the final short chunk pads with invalid
        codes."""
        CH = _DENSE_CHUNK
        n = len(codes)
        start = 0
        while start < n:
            end = min(start + CH, n)
            if end < n:
                seps = np.nonzero(codes[start:end] == _SENTINEL)[0]
                if len(seps):
                    end = start + int(seps[-1]) + 1
            chunk = codes[start:end]
            if end < n and codes[end - 1] != _SENTINEL:
                # a single >CH-code sequence forced a mid-sequence cut:
                # overlap the next chunk by k-1 codes so boundary-spanning
                # windows count exactly once
                next_start = end - (k - 1)
            else:
                next_start = end
            if len(chunk) < CH:
                chunk = np.concatenate(
                    [chunk, np.full(CH - len(chunk), _SENTINEL, np.uint8)]
                )
            words, bad = _to_device_words(*_pack_codes_2bit(chunk), table.device)
            _dense_count_chunk(table, words, bad, k)
            start = next_start

    @classmethod
    def _from_seqs_sorted(cls, seqs, k: int, min_count: int, device):
        """Sorted counter: the canonical code of every window of the one
        packed buffer (invalid windows -> 4^k, which sorts last), one sort
        on `device`, then run starts and run lengths; the (distinct k-mer,
        count) table comes back to the host."""
        self = cls(k)
        words, bad = _to_device_words(*_pack_one_buffer(seqs, k), device)
        SORTED_TABLES[words.device.type] += 1
        codes = torch.sort(_canonical_window_codes(words, bad, k)).values
        n = int((codes < 4**k).sum())
        if n == 0:
            return self
        codes = codes[:n]
        starts = torch.ones(n, dtype=torch.bool, device=codes.device)
        starts[1:] = codes[1:] != codes[:-1]
        first = torch.nonzero(starts).flatten()
        counts = torch.diff(first, append=first.new_tensor([n]))
        kmers = codes[first].cpu().numpy().astype(np.uint32)
        counts = counts.cpu().numpy()
        if min_count > 0:
            keep = counts >= min_count
            kmers, counts = kmers[keep], counts[keep]
        self.kmers, self.counts = kmers, counts
        return self

    @classmethod
    def from_sequences(cls, seqs, k: int = 15, min_count: int = 0, *, device):
        """Count table over `seqs` by the counter `counter_for` names for
        `device` and the read set's size."""
        self = cls(k)
        seqs = list(seqs)
        # the joined sentinel-separated stream is one code per base plus
        # one separator per read — known without building it
        n_codes = sum(len(s) for s in seqs) + len(seqs)
        if n_codes < k:
            return self
        counter = counter_for(torch.device(device).type, n_codes)
        if counter == "sorted":
            return cls._from_seqs_sorted(seqs, k, min_count, device)
        if counter == "dense":
            return cls._from_seqs_dense(seqs, k, min_count, device)
        codes = _concat_codes(seqs)
        if len(codes) < k:
            return self
        # chunked: the doubling-code temporaries are ~10x the chunk size,
        # so bound the chunk (gigabase inputs would otherwise need tens of
        # GB); per-chunk unique tables merge by sorted run-length sum.
        # Chunks split at separator boundaries so no window spans two
        # chunks.
        CHUNK = _HOST_COUNT_CHUNK
        n = len(codes)
        use_bincount = n >= _HOST_BINCOUNT_MIN and 4**k <= 1 << 30
        table = np.zeros(4**k, dtype=np.int64) if use_bincount else None
        parts_k, parts_c = [], []
        start = 0
        while start < n:
            end = min(start + CHUNK, n)
            mid_sequence_cut = False
            if end < n:
                # codes[end-1] may be mid-sequence: back up to the last
                # separator so windows stay intact
                seps = np.nonzero(codes[start:end] == _SENTINEL)[0]
                if len(seps) == 0:
                    # a single >CHUNK-code sequence: cut anyway and overlap
                    # the next chunk by k-1 codes so boundary-spanning
                    # windows count exactly once
                    mid_sequence_cut = True
                else:
                    end = start + int(seps[-1]) + 1
            wc = _host_canonical_codes(codes[start:end], k)
            if len(wc):
                if use_bincount:
                    # gigabase inputs: one O(N) scatter into the dense 4^k
                    # table beats sorting every chunk; bincount WITHOUT
                    # minlength, added into a slice, avoids a fresh
                    # full-size temp per chunk
                    bc = np.bincount(wc)
                    table[: len(bc)] += bc
                else:
                    uk, uc = np.unique(wc, return_counts=True)
                    parts_k.append(uk)
                    parts_c.append(uc.astype(np.int64))
            start = end - (k - 1) if mid_sequence_cut else end
        if use_bincount:
            kmers = np.nonzero(table)[0].astype(np.uint32)
            counts = table[kmers.astype(np.int64)]
        elif not parts_k:
            return self
        elif len(parts_k) == 1:
            kmers, counts = parts_k[0], parts_c[0]
        else:
            allk = np.concatenate(parts_k)
            allc = np.concatenate(parts_c)
            order = np.argsort(allk, kind="stable")
            allk, allc = allk[order], allc[order]
            boundary = np.concatenate([[True], allk[1:] != allk[:-1]])
            idx = np.nonzero(boundary)[0]
            kmers = allk[idx]
            sums = np.zeros(len(allk) + 1, np.int64)
            np.cumsum(allc, out=sums[1:])
            counts = sums[np.append(idx[1:], len(allk))] - sums[idx]
        if len(kmers) == 0:
            return self
        if min_count > 0:
            keep = counts >= min_count
            kmers, counts = kmers[keep], counts[keep]
        self.kmers, self.counts = kmers, counts
        return self

    def histo(self) -> dict[int, int]:
        """count -> number of distinct k-mers with that count
        (jellyfish histo), in ascending count order."""
        if self.dense is not None:
            return _dense_histo(self.dense, _HISTO_CAP)
        if len(self.counts) == 0:
            return {}
        values, freqs = np.unique(self.counts, return_counts=True)
        return {int(v): int(f) for v, f in zip(values, freqs)}

    def query_sequences(self, seqs) -> np.ndarray:
        """Count of every k-mer occurrence of `seqs` in this table
        (jellyfish query): one entry per valid k-mer window, 0 when absent."""
        codes = _concat_codes(list(seqs))
        if len(codes) < self.k:
            return np.zeros(0, dtype=np.int64)
        window_codes = _host_canonical_codes(codes, self.k)
        if self.dense is not None:
            idx = torch.from_numpy(window_codes.astype(np.int64))
            return self.dense[idx.to(self.dense.device)].cpu().numpy().astype(np.int64)
        if len(window_codes) == 0 or len(self.kmers) == 0:
            return np.zeros(len(window_codes), dtype=np.int64)
        idx = np.searchsorted(self.kmers, window_codes)
        idx = np.clip(idx, 0, len(self.kmers) - 1)
        hit = self.kmers[idx] == window_codes
        return np.where(hit, self.counts[idx], 0)


# ------------------------------------------------- copy-number estimation


def kmer_cutoff_estimation(kmer_counts: dict[int, int]) -> int:
    """Fit a 2-component Poisson mixture (error mu=1 vs signal mu=c) and
    return the smallest count where signal dominates
    (result_utils.py:975-1004)."""
    from scipy.optimize import minimize
    from scipy.stats import poisson

    i_values = np.array(list(kmer_counts.keys()))
    xi_values = np.array(list(kmer_counts.values()))

    def neg_log_likelihood(params):
        w, c = params
        if w < 0 or w > 1 or c <= 0:
            return np.inf
        error_prob = poisson.pmf(i_values, mu=1)
        real_prob = poisson.pmf(i_values, mu=c)
        mix = w * error_prob + (1 - w) * real_prob
        mix[mix == 0] = 1e-10
        return -np.sum(xi_values * np.log(mix))

    result = minimize(neg_log_likelihood, [0.1, 10], method="BFGS")
    w_opt, c_opt = result.x
    for i in i_values:
        if poisson.pmf(i, mu=c_opt) * (1 - w_opt) > poisson.pmf(i, mu=1) * w_opt:
            return int(i)
    return 0


def estimate_kmer_depth(kmer_counts: dict[int, int]) -> int:
    """Highest peak of the smoothed log k-mer count histogram
    (result_utils.py:1007-1022)."""
    from scipy.signal import find_peaks, savgol_filter

    x_values, y_values = zip(*sorted(kmer_counts.items()))
    log_counts = np.log(np.array(y_values) + 1)
    if len(log_counts) < 5:
        # too sparse to smooth: take the most frequent count directly
        return int(x_values[int(np.argmax(log_counts))])
    window_length = min(29, len(log_counts) // 2 * 2 + 1, len(log_counts))
    smoothed = savgol_filter(log_counts, window_length, min(3, window_length - 1))
    peak_indices, _ = find_peaks(smoothed)
    if len(peak_indices) == 0:
        peak_indices = np.array([int(np.argmax(smoothed))])
    max_peak = peak_indices[int(np.argmax(smoothed[peak_indices]))]
    return int(x_values[max_peak])


def estimate_overall_read_depth(sequences, k: int = 15, *, device):
    """Count -> cutoff-fit -> recount -> depth peak
    (result_utils.py:1050-1080). Returns (depth, filtered KmerCounter)."""
    full = KmerCounter.from_sequences(sequences, k, device=device)
    full_histo = full.histo()
    cutoff = kmer_cutoff_estimation(full_histo)
    # the recount with -L cutoff (result_utils.py:1070-1076) is exactly a
    # filter of the full table: no second windowing pass
    filtered = KmerCounter(k)
    if full.dense is not None:
        # in place: the unfiltered table is not needed again, and a second
        # table would double the 4 GiB of device memory at k = 15
        filtered.dense = _dense_filter_(full.dense, max(cutoff, 1))
        # the filtered histogram is the full histogram above the cutoff
        filtered_histo = {
            v: f for v, f in full_histo.items() if v >= max(cutoff, 1)
        }
    else:
        # a sorted or host table is on the host already: filtered there
        keep = full.counts >= max(cutoff, 1)
        filtered.kmers, filtered.counts = full.kmers[keep], full.counts[keep]
        filtered_histo = filtered.histo()
    depth = estimate_kmer_depth(filtered_histo)
    return depth, filtered


def estimate_depth_for_reads(counter: KmerCounter, sequences) -> float:
    """Median count of the reads' k-mers in the filtered table, dropping
    zero-count entries (result_utils.py:1037-1047, 1083-1086)."""
    if counter.dense is not None:
        sequences = list(sequences)
        n_codes = sum(len(s) for s in sequences) + len(sequences)
        if n_codes < counter.k:
            return 0.0
        words, bad = _to_device_words(
            *_pack_one_buffer(sequences, counter.k), counter.dense.device
        )
        med2, nnz = _dense_query_median2(counter.dense, words, bad, counter.k)
        if nnz == 0:
            return 0.0
        return float(med2) / 2.0
    counts = counter.query_sequences(sequences)
    counts = counts[counts != 0]
    if len(counts) == 0:
        return 0.0
    return float(np.median(counts))
