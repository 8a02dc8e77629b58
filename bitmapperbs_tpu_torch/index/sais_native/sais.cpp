// SA-IS suffix array construction (native index-build core).
//
// Reference parity: BitMapperBS vendors pSAscan / libdivsufsort for suffix
// array construction (SURVEY.md C4).  This is our native equivalent: a
// from-scratch linear-time SA-IS (Nong/Zhang/Chan induced sorting) over
// uint8 text with int64 positions, suitable for whole-genome (3.1e9) builds
// in RAM.  Exposed to Python via ctypes (no pybind11 in this environment).
//
// Contract: text[n-1] must be a unique smallest sentinel (value 0).

#include <cstdint>
#include <cstring>
#include <new>
#include <vector>

namespace {

template <typename T>
struct Level {
  const T* s;
  int64_t* sa;
  int64_t n;
  int64_t K;
  std::vector<uint8_t> type;  // 1 = S-type
  std::vector<int64_t> bkt;

  bool is_lms(int64_t i) const { return i > 0 && type[i] && !type[i - 1]; }

  void bucket_starts() {
    std::fill(bkt.begin(), bkt.end(), 0);
    for (int64_t i = 0; i < n; ++i) bkt[s[i]]++;
    int64_t sum = 0;
    for (int64_t c = 0; c < K; ++c) {
      int64_t cnt = bkt[c];
      bkt[c] = sum;
      sum += cnt;
    }
  }

  void bucket_ends() {
    std::fill(bkt.begin(), bkt.end(), 0);
    for (int64_t i = 0; i < n; ++i) bkt[s[i]]++;
    int64_t sum = 0;
    for (int64_t c = 0; c < K; ++c) {
      sum += bkt[c];
      bkt[c] = sum;
    }
  }

  void induce_l() {
    bucket_starts();
    for (int64_t i = 0; i < n; ++i) {
      int64_t j = sa[i];
      if (j > 0 && !type[j - 1]) sa[bkt[s[j - 1]]++] = j - 1;
    }
  }

  void induce_s() {
    bucket_ends();
    for (int64_t i = n - 1; i >= 0; --i) {
      int64_t j = sa[i];
      if (j > 0 && type[j - 1]) sa[--bkt[s[j - 1]]] = j - 1;
    }
  }
};

template <typename T>
void sais_rec(const T* s, int64_t* sa, int64_t n, int64_t K) {
  if (n == 1) {
    sa[0] = 0;
    return;
  }
  Level<T> lv{s, sa, n, K, std::vector<uint8_t>(n), std::vector<int64_t>(K)};
  if (n < 2) return;  // unreachable (n==1 handled); placates -Wstringop-overflow
  lv.type[n - 1] = 1;
  for (int64_t i = n - 2; i >= 0; --i)
    lv.type[i] = (s[i] < s[i + 1] || (s[i] == s[i + 1] && lv.type[i + 1])) ? 1 : 0;

  // stage 1: induce-sort LMS substrings
  std::fill(sa, sa + n, int64_t(-1));
  lv.bucket_ends();
  for (int64_t i = 1; i < n; ++i)
    if (lv.is_lms(i)) sa[--lv.bkt[s[i]]] = i;
  lv.induce_l();
  lv.induce_s();

  // compact sorted LMS positions into sa[0..n1)
  int64_t n1 = 0;
  for (int64_t i = 0; i < n; ++i) {
    int64_t j = sa[i];
    if (j > 0 && lv.type[j] && !lv.type[j - 1]) sa[n1++] = j;
  }

  // name LMS substrings into sa[n1..n) at slot pos/2
  std::fill(sa + n1, sa + n, int64_t(-1));
  int64_t name = 0, prev = -1;
  for (int64_t i = 0; i < n1; ++i) {
    int64_t pos = sa[i];
    bool diff = false;
    for (int64_t d = 0; d < n; ++d) {
      if (prev == -1 || s[pos + d] != s[prev + d] ||
          lv.type[pos + d] != lv.type[prev + d]) {
        diff = true;
        break;
      }
      if (d > 0 && (lv.is_lms(pos + d) || lv.is_lms(prev + d))) break;
    }
    if (diff) {
      ++name;
      prev = pos;
    }
    sa[n1 + pos / 2] = name - 1;
  }
  for (int64_t i = n - 1, j = n - 1; i >= n1; --i)
    if (sa[i] >= 0) sa[j--] = sa[i];

  // stage 2: recurse on the reduced string if names are not yet unique
  int64_t* s1 = sa + n - n1;
  if (name < n1) {
    sais_rec<int64_t>(s1, sa, n1, name);
  } else {
    for (int64_t i = 0; i < n1; ++i) sa[s1[i]] = i;
  }

  // stage 3: induce the full SA from the sorted LMS suffixes
  for (int64_t i = 1, j = 0; i < n; ++i)
    if (lv.is_lms(i)) s1[j++] = i;            // LMS positions in text order
  for (int64_t i = 0; i < n1; ++i) sa[i] = s1[sa[i]];
  std::fill(sa + n1, sa + n, int64_t(-1));
  lv.bucket_ends();
  for (int64_t i = n1 - 1; i >= 0; --i) {
    int64_t j = sa[i];
    sa[i] = -1;
    sa[--lv.bkt[s[j]]] = j;
  }
  lv.induce_l();
  lv.induce_s();
}

}  // namespace

extern "C" {

// Returns 0 on success, nonzero on invalid input / allocation failure.
int sais_u8_i64(const uint8_t* text, int64_t* sa, int64_t n) {
  if (n <= 0 || text == nullptr || sa == nullptr) return 1;
  if (text[n - 1] != 0) return 2;  // sentinel required
  for (int64_t i = 0; i + 1 < n; ++i)
    if (text[i] == 0) return 3;    // sentinel must be unique
  try {
    sais_rec<uint8_t>(text, sa, n, 256);
  } catch (const std::bad_alloc&) {
    return 4;
  }
  return 0;
}

}  // extern "C"

// Self-test main for the sanitizer build (`make check-asan`): random texts
// verified against a naive O(n^2 log n) comparison sort.
#ifdef SAIS_SELFTEST
#include <algorithm>
#include <cstdio>
#include <cstdlib>

int main() {
  unsigned seed = 12345;
  for (int iter = 0; iter < 50; ++iter) {
    int64_t n = 2 + rand_r(&seed) % 2000;
    std::vector<uint8_t> t(n);
    for (int64_t i = 0; i + 1 < n; ++i) t[i] = 1 + rand_r(&seed) % 3;
    t[n - 1] = 0;
    std::vector<int64_t> sa(n), want(n);
    if (sais_u8_i64(t.data(), sa.data(), n) != 0) { std::puts("FAIL rc"); return 1; }
    for (int64_t i = 0; i < n; ++i) want[i] = i;
    std::sort(want.begin(), want.end(), [&](int64_t a, int64_t b) {
      while (a < n && b < n) {
        if (t[a] != t[b]) return t[a] < t[b];
        ++a; ++b;
      }
      return a == n;
    });
    if (sa != want) { std::puts("FAIL sa"); return 1; }
  }
  std::puts("OK");
  return 0;
}
#endif
