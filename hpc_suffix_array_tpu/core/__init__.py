"""Single-device algorithm core (pure JAX, jit-compiled).

Data-parallel re-design of the reference's C core
(src/sequential/manber_myers.c, public API src/common/suffix_array.h:24-29):
struct-of-arrays ranks instead of ``Suffix[]`` records, a ``lax.while_loop``
doubling driver with early termination, scan-based re-ranking, a parallel
PLCP algorithm in place of sequential Kasai, and an O(n) vectorized validator
in place of the reference's O(n^2) strcmp check.
"""
