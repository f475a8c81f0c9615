"""Row helpers of cross-job batching, copied from
chiaswarm_tpu/pipelines/common.py (the port imports nothing of the JAX
package): the padded row count of a coalesced pass, the split of its
images back into requests, and the chunks of requests that fit one pass.
"""

from __future__ import annotations


def pad_bucket(rows: int) -> int:
    """Next power-of-two row count >= rows: coalesce factors 3 and 4 run
    the same batch shape (and the same GEMM and GroupNorm plans)."""
    p = 1
    while p < rows:
        p *= 2
    return p


def split_by_counts(items, counts: list[int]) -> list[list]:
    """A flat per-row list -> one list per request; trailing padding rows
    (len(items) > sum(counts)) are dropped."""
    out, offset = [], 0
    for n in counts:
        out.append(list(items[offset:offset + n]))
        offset += n
    return out


def chunk_by_rows(counts: list[int], max_rows: int) -> list[tuple[int, int]]:
    """Greedy [start, end) request ranges whose row sums fit max_rows.
    Requests are atomic: one request's images never straddle two passes,
    and a request larger than max_rows gets a chunk of its own."""
    chunks: list[tuple[int, int]] = []
    start, rows = 0, 0
    for i, n in enumerate(counts):
        if i > start and rows + n > max_rows:
            chunks.append((start, i))
            start, rows = i, 0
        rows += n
    chunks.append((start, len(counts)))
    return chunks
