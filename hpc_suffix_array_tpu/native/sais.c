/* Native host-side suffix-array helpers for hpc_suffix_array_tpu.
 *
 * Linear-time SA-IS construction (induced sorting), Kasai LCP, and an
 * O(n) suffix-array validator. The SA-IS code follows the canonical
 * Nong-Zhang-Chan algorithm structure (IS_LMS classification, induce-L /
 * induce-S passes, LMS renaming) as published in "Two Efficient
 * Algorithms for Linear Time Suffix Array Construction" (2011) - the
 * standard formulation any SA-IS implementation shares; it is not
 * derived from the reference, which contains no SA-IS.
 * These are the native runtime pieces
 * around the device compute path: a fast trusted oracle for tests and
 * validation of large corpora, and the host-side baseline the benchmark
 * harness can compare against.
 *
 * Role parity with the reference's native core (src/sequential/
 * manber_myers.c: build_suffix_array :81-133, build_lcp_array :135-157,
 * is_valid_suffix_array :184-202) - but a different, asymptotically better
 * algorithm (SA-IS O(n) vs prefix-doubling O(n log n)), and a linear-time
 * validator instead of the reference's O(n^2)-worst-case strcmp walk.
 *
 * Build: cc -O3 -shared -fPIC sais.c -o _native.so (done lazily by
 * native/__init__.py; any failure falls back to pure Python).
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define IS_LMS(t, i) ((i) > 0 && (t)[(i)] && !(t)[(i) - 1])

static void bucket_bounds(const int32_t *s, int32_t *bkt, int32_t n,
                          int32_t K, int ends) {
    int32_t i, sum = 0;
    for (i = 0; i < K; i++) bkt[i] = 0;
    for (i = 0; i < n; i++) bkt[s[i]]++;
    for (i = 0; i < K; i++) {
        sum += bkt[i];
        bkt[i] = ends ? sum : sum - bkt[i];
    }
}

static void induce_l(const int32_t *s, int32_t *sa, const uint8_t *t,
                     int32_t *bkt, int32_t n, int32_t K) {
    bucket_bounds(s, bkt, n, K, 0);
    for (int32_t i = 0; i < n; i++) {
        int32_t j = sa[i] - 1;
        if (sa[i] > 0 && !t[j]) sa[bkt[s[j]]++] = j;
    }
}

static void induce_s(const int32_t *s, int32_t *sa, const uint8_t *t,
                     int32_t *bkt, int32_t n, int32_t K) {
    bucket_bounds(s, bkt, n, K, 1);
    for (int32_t i = n - 1; i >= 0; i--) {
        int32_t j = sa[i] - 1;
        if (sa[i] > 0 && t[j]) sa[--bkt[s[j]]] = j;
    }
}

/* Core SA-IS on s[0..n-1] with alphabet [0, K); s[n-1] must be the unique
 * smallest sentinel. Writes the suffix array into sa[0..n-1]. Returns 0 on
 * success, -1 on allocation failure. */
static int sais(const int32_t *s, int32_t *sa, int32_t n, int32_t K) {
    if (n == 1) { sa[0] = 0; return 0; }

    uint8_t *t = (uint8_t *)malloc((size_t)n);
    int32_t *bkt = (int32_t *)malloc(sizeof(int32_t) * (size_t)K);
    if (!t || !bkt) { free(t); free(bkt); return -1; }

    /* Classify S(1)/L(0) types right-to-left. */
    t[n - 1] = 1;
    for (int32_t i = n - 2; i >= 0; i--)
        t[i] = (s[i] < s[i + 1]) || (s[i] == s[i + 1] && t[i + 1]);

    /* Stage 1: approximate-sort LMS suffixes by one induced pass. */
    memset(sa, -1, sizeof(int32_t) * (size_t)n);
    bucket_bounds(s, bkt, n, K, 1);
    for (int32_t i = 1; i < n; i++)
        if (IS_LMS(t, i)) sa[--bkt[s[i]]] = i;
    induce_l(s, sa, t, bkt, n, K);
    induce_s(s, sa, t, bkt, n, K);

    /* Compact the (now LMS-substring-sorted) LMS positions to the front. */
    int32_t n1 = 0;
    for (int32_t i = 0; i < n; i++)
        if (IS_LMS(t, sa[i])) sa[n1++] = sa[i];

    /* Name LMS substrings into the back half (indexed by pos/2). */
    memset(sa + n1, -1, sizeof(int32_t) * (size_t)(n - n1));
    int32_t name = 0, prev = -1;
    for (int32_t i = 0; i < n1; i++) {
        int32_t pos = sa[i], diff = 0;
        if (prev < 0) diff = 1;
        else {
            for (int32_t d = 0;; d++) {
                if (s[pos + d] != s[prev + d] || t[pos + d] != t[prev + d]) {
                    diff = 1;
                    break;
                }
                if (d > 0 && (IS_LMS(t, pos + d) || IS_LMS(t, prev + d))) {
                    diff = !(IS_LMS(t, pos + d) && IS_LMS(t, prev + d));
                    break;
                }
            }
        }
        if (diff) { name++; prev = pos; }
        sa[n1 + pos / 2] = name - 1;
    }
    for (int32_t i = n - 1, j = n - 1; i >= n1; i--)
        if (sa[i] >= 0) sa[j--] = sa[i];

    /* Recurse on the reduced string if names collide. */
    int32_t *s1 = sa + n - n1;
    if (name < n1) {
        if (sais(s1, sa, n1, name) != 0) { free(t); free(bkt); return -1; }
    } else {
        for (int32_t i = 0; i < n1; i++) sa[s1[i]] = i;
    }

    /* Map reduced SA back to LMS text positions. */
    for (int32_t i = 1, j = 0; i < n; i++)
        if (IS_LMS(t, i)) s1[j++] = i;
    for (int32_t i = 0; i < n1; i++) sa[i] = s1[sa[i]];

    /* Stage 2: induce the full SA from the exactly-sorted LMS order. */
    memset(sa + n1, -1, sizeof(int32_t) * (size_t)(n - n1));
    bucket_bounds(s, bkt, n, K, 1);
    for (int32_t i = n1 - 1; i >= 0; i--) {
        int32_t j = sa[i];
        sa[i] = -1;
        sa[--bkt[s[j]]] = j;
    }
    induce_l(s, sa, t, bkt, n, K);
    induce_s(s, sa, t, bkt, n, K);

    free(t);
    free(bkt);
    return 0;
}

/* Public: suffix array of a byte string (no sentinel in the input). */
int native_sa_build(const uint8_t *text, int32_t n, int32_t *sa_out) {
    if (n <= 0) return 0;
    if (n == 1) { sa_out[0] = 0; return 0; }
    int32_t *s = (int32_t *)malloc(sizeof(int32_t) * (size_t)(n + 1));
    int32_t *sa = (int32_t *)malloc(sizeof(int32_t) * (size_t)(n + 1));
    if (!s || !sa) { free(s); free(sa); return -1; }
    for (int32_t i = 0; i < n; i++) s[i] = (int32_t)text[i] + 1;
    s[n] = 0; /* unique smallest sentinel */
    int rc = sais(s, sa, n + 1, 258);
    if (rc == 0) memcpy(sa_out, sa + 1, sizeof(int32_t) * (size_t)n);
    free(s);
    free(sa);
    return rc;
}

/* Kasai O(n) LCP: lcp[j] = LCP(suffix sa[j-1], suffix sa[j]), lcp[0]=0. */
int native_lcp_kasai(const uint8_t *text, const int32_t *sa, int32_t n,
                  int32_t *lcp) {
    if (n <= 0) return 0;
    int32_t *rank = (int32_t *)malloc(sizeof(int32_t) * (size_t)n);
    if (!rank) return -1;
    for (int32_t i = 0; i < n; i++) rank[sa[i]] = i;
    int32_t h = 0;
    lcp[0] = 0;
    for (int32_t i = 0; i < n; i++) {
        if (rank[i] > 0) {
            int32_t j = sa[rank[i] - 1];
            while (i + h < n && j + h < n && text[i + h] == text[j + h]) h++;
            lcp[rank[i]] = h;
            if (h > 0) h--;
        } else {
            h = 0;
        }
    }
    free(rank);
    return 0;
}

/* O(n) validator: permutation + adjacent-order check via ISA.
 * Returns 1 if valid, 0 if not, -1 on allocation failure. */
int native_sa_validate(const uint8_t *text, const int32_t *sa, int32_t n) {
    if (n <= 0) return 1;
    int32_t *isa = (int32_t *)malloc(sizeof(int32_t) * (size_t)n);
    if (!isa) return -1;
    memset(isa, -1, sizeof(int32_t) * (size_t)n);
    for (int32_t i = 0; i < n; i++) {
        if (sa[i] < 0 || sa[i] >= n || isa[sa[i]] != -1) {
            free(isa);
            return 0;
        }
        isa[sa[i]] = i;
    }
    for (int32_t i = 1; i < n; i++) {
        int32_t a = sa[i - 1], b = sa[i];
        if (text[a] != text[b]) {
            if (text[a] > text[b]) { free(isa); return 0; }
        } else {
            /* equal first byte: order follows the successor suffixes */
            if (a + 1 == n) continue;            /* shorter sorts first */
            if (b + 1 == n || isa[a + 1] > isa[b + 1]) {
                free(isa);
                return 0;
            }
        }
    }
    free(isa);
    return 1;
}
