"""On-device k-mer index build (SURVEY.md §1 L1, §7 M0).

The reference ecosystem builds its dictionary with external disk sorts
(GECKO `words`/`sortWords`/`w2hd`, SURVEY.md §2.2); the device design
replaces that with flat sorted arrays in HBM: extract every k-mer with
shifts/gathers, then one `lax.sort` over (kmer, validity, position).

Static shapes: a sequence of length L yields exactly L-k+1 slots; windows
containing N are invalid. Invalid slots get kmer = 0xFFFFFFFF and sort to
the tail of the (kmer, invalid, pos) order — note valid all-T k=16 k-mers
share that key value, which is why `invalid` is the SECOND key: the valid
prefix of the sorted array is still globally sorted by kmer, so binary
search against it is correct after clamping to n_valid (seeds/join.py).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

SENTINEL = jnp.uint32(0xFFFFFFFF)


def extract_kmers(codes: jnp.ndarray, k: int) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """uint8 codes[L] -> (kmer uint32[n], pos int32[n], valid bool[n]), n = L-k+1.

    Big-endian base packing (first base in the top bits), matching
    oracle.pipeline.extract_kmers bit-for-bit.
    """
    L = codes.shape[0]
    n = L - k + 1
    if n <= 0:
        return (jnp.zeros(0, jnp.uint32), jnp.zeros(0, jnp.int32), jnp.zeros(0, bool))
    km = jnp.zeros(n, jnp.uint32)
    valid = jnp.ones(n, bool)
    for i in range(k):
        w = jax.lax.dynamic_slice(codes, (i,), (n,))
        valid = valid & (w < 4)
        km = (km << jnp.uint32(2)) | jnp.where(w < 4, w, 0).astype(jnp.uint32)
    pos = jnp.arange(n, dtype=jnp.int32)
    return km, pos, valid


def build_index(codes: jnp.ndarray, k: int) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Sorted k-mer index: (kmer uint32[n], pos int32[n], n_valid int32).

    Sort key is (kmer, invalid, pos): ascending lexicographic; invalid
    slots (kmer forced to SENTINEL) land strictly after any valid slot of
    equal kmer, giving a valid, kmer-sorted prefix of length n_valid.
    """
    km, pos, valid = extract_kmers(codes, k)
    invalid = (~valid).astype(jnp.int32)
    km = jnp.where(valid, km, SENTINEL)
    km_s, inv_s, pos_s = jax.lax.sort((km, invalid, pos), num_keys=3)
    n_valid = jnp.sum(valid.astype(jnp.int32))
    return km_s, pos_s, n_valid


@functools.partial(jax.jit, static_argnames=("k",))
def build_index_jit(codes: jnp.ndarray, k: int):
    return build_index(codes, k)
