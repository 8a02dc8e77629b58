// Bounded-RAM BWT construction by dynamic insertion (native index-build
// core, low-memory mode).
//
// Reference parity: BitMapperBS vendors pSAscan so a whole human genome can
// be indexed without holding a suffix array in RAM (SURVEY.md C4, the
// external-memory role).  This is our equivalent: no suffix array is built
// at all -- the BWT of the converted text grows right-to-left by the
// classic dynamic-BWT insertion algorithm (replace the $ row with the new
// character, re-insert $ at its LF position) over a B+-tree of
// 2-bit-packed leaves with per-subtree symbol counts.  Peak RAM is
// ~0.5 bytes/char (tree) plus the packed outputs, vs ~12 bytes/char for
// in-RAM SA-IS.
//
// After construction, two LF walks over the finished static packed BWT
// recover every suffix's text position in O(n) rank queries, emitting the
// SA-sample mark bits and row-order samples -- artifacts byte-identical to
// the SA-IS path (asserted by the selftest main and tests/test_bwtinc.py).
//
// Alphabet: codes 0..3, code 0 = unique smallest sentinel at text[n-1].

#include <cstdint>
#include <cstring>
#include <new>
#include <vector>

namespace {

constexpr int LEAF_CAP = 1024;          // chars per leaf
constexpr int LEAF_WORDS = LEAF_CAP / 32;  // 2-bit codes in u64 words
constexpr int FANOUT = 32;
constexpr int MAX_DEPTH = 16;

inline int64_t pc64(uint64_t x) { return __builtin_popcountll(x); }

// count occurrences of 2-bit code c among the first `k` codes of word w
inline int64_t word_rank(uint64_t w, int c, int k) {
  uint64_t x = w ^ (0x5555555555555555ULL * (uint64_t)c);
  uint64_t hit = ~x & (~x >> 1) & 0x5555555555555555ULL;
  if (k < 32) hit &= (1ULL << (2 * k)) - 1;
  return pc64(hit);
}
inline int64_t word_count(uint64_t w, int c, int nvalid) {
  return word_rank(w, c, nvalid);
}

struct Leaf {
  int32_t size = 0;
  int64_t cnt[4] = {0, 0, 0, 0};
  uint64_t data[LEAF_WORDS] = {0};

  inline int get(int i) const { return (data[i >> 5] >> ((i & 31) * 2)) & 3; }
  inline void set(int i, int c) {
    int sh = (i & 31) * 2;
    data[i >> 5] = (data[i >> 5] & ~(3ULL << sh)) | ((uint64_t)c << sh);
  }

  void insert(int pos, int c) {
    // shift codes [pos, size) up by one position (2 bits), across words
    int w0 = pos >> 5, lastw = size >> 5;
    for (int w = lastw; w > w0; --w)
      data[w] = (data[w] << 2) | (data[w - 1] >> 62);
    int sh = (pos & 31) * 2;
    uint64_t lo_mask = sh ? ((1ULL << sh) - 1) : 0ULL;
    uint64_t w = data[w0];
    data[w0] = (w & lo_mask) | ((w & ~lo_mask) << 2);
    set(pos, c);
    ++size;
    ++cnt[c];
  }

  int64_t rank(int c, int pos) const {  // count of c in [0, pos)
    int64_t r = 0;
    int full = pos >> 5;
    for (int w = 0; w < full; ++w) r += word_count(data[w], c, 32);
    if (pos & 31) r += word_rank(data[full], c, pos & 31);
    return r;
  }
};

struct Node {
  bool is_leaf;                       // children are Leaf*
  int32_t nkids = 0;
  int64_t size = 0;
  int64_t cnt[4] = {0, 0, 0, 0};
  void* kid[FANOUT];

  explicit Node(bool leaf) : is_leaf(leaf) {}
};

struct DynBWT {
  Node* root;
  std::vector<Node*> nodes;
  std::vector<Leaf*> leaves;

  Leaf* new_leaf() { leaves.push_back(new Leaf()); return leaves.back(); }
  Node* new_node(bool lf) { nodes.push_back(new Node(lf)); return nodes.back(); }

  DynBWT() {
    root = new_node(true);
    root->kid[root->nkids++] = new_leaf();
  }
  ~DynBWT() {
    for (Leaf* l : leaves) delete l;
    for (Node* x : nodes) delete x;
  }

  static int64_t kid_size(const Node* p, int k) {
    return p->is_leaf ? ((Leaf*)p->kid[k])->size : ((Node*)p->kid[k])->size;
  }
  static const int64_t* kid_cnt(const Node* p, int k) {
    return p->is_leaf ? ((Leaf*)p->kid[k])->cnt : ((Node*)p->kid[k])->cnt;
  }

  // count of symbol c in [0, pos) -- read-only descent
  int64_t rank(int c, int64_t pos) const {
    int64_t r = 0;
    const Node* x = root;
    for (;;) {
      int k = 0;
      for (; k + 1 < x->nkids; ++k) {
        int64_t s = kid_size(x, k);
        if (pos <= s) break;
        pos -= s;
        r += kid_cnt(x, k)[c];
      }
      if (x->is_leaf) return r + ((Leaf*)x->kid[k])->rank(c, (int)pos);
      x = (const Node*)x->kid[k];
    }
  }

  // replace the symbol at `pos` (must currently be `old`) with c
  void set_symbol(int64_t pos, int old, int c) {
    Node* x = root;
    for (;;) {
      x->cnt[old] -= 1;
      x->cnt[c] += 1;
      int k = 0;
      for (; k + 1 < x->nkids; ++k) {
        int64_t s = kid_size(x, k);
        if (pos < s) break;
        pos -= s;
      }
      if (x->is_leaf) {
        Leaf* l = (Leaf*)x->kid[k];
        l->set((int)pos, c);
        --l->cnt[old];
        ++l->cnt[c];
        return;
      }
      x = (Node*)x->kid[k];
    }
  }

  // insert symbol c at position pos
  void insert(int64_t pos, int c) {
    Node* path[MAX_DEPTH];
    int pk[MAX_DEPTH];
    int depth = 0;
    Node* x = root;
    for (;;) {
      x->size += 1;
      x->cnt[c] += 1;
      int k = 0;
      for (; k + 1 < x->nkids; ++k) {
        int64_t s = kid_size(x, k);
        if (pos <= s) break;
        pos -= s;
      }
      path[depth] = x;
      pk[depth] = k;
      ++depth;
      if (x->is_leaf) {
        Leaf* l = (Leaf*)x->kid[k];
        l->insert((int)pos, c);
        if (l->size == LEAF_CAP) split_up(path, pk, depth);
        return;
      }
      x = (Node*)x->kid[k];
    }
  }

  void insert_kid(Node* p, int at, void* kid) {
    for (int i = p->nkids; i > at; --i) p->kid[i] = p->kid[i - 1];
    p->kid[at] = kid;
    ++p->nkids;
  }

  void split_up(Node** path, int* pk, int depth) {
    Node* p = path[depth - 1];
    Leaf* l = (Leaf*)p->kid[pk[depth - 1]];
    Leaf* r = new_leaf();
    int half = l->size / 2;
    for (int i = half; i < l->size; ++i) {
      int c = l->get(i);
      r->set(r->size++, c);
      ++r->cnt[c];
      --l->cnt[c];
    }
    l->size = half;
    std::memset(l->data + (half + 31) / 32, 0,
                (LEAF_WORDS - (half + 31) / 32) * 8);
    // clear codes in the partial word past `half`
    if (half & 31) {
      uint64_t keep = (1ULL << (2 * (half & 31))) - 1;
      l->data[half >> 5] &= keep;
    }
    insert_kid(p, pk[depth - 1] + 1, r);
    for (int d = depth - 1; d > 0; --d) {
      if (path[d]->nkids < FANOUT) break;
      split_node(path[d - 1], pk[d - 1]);
    }
    if (root->nkids == FANOUT) {
      Node* nr = new_node(false);
      nr->size = root->size;
      std::memcpy(nr->cnt, root->cnt, sizeof nr->cnt);
      nr->kid[nr->nkids++] = root;
      root = nr;
      split_node(root, 0);
    }
  }

  void split_node(Node* parent, int at) {
    Node* x = (Node*)parent->kid[at];
    Node* y = new_node(x->is_leaf);
    int half = x->nkids / 2;
    for (int i = half; i < x->nkids; ++i) {
      void* k = x->kid[i];
      y->kid[y->nkids++] = k;
      int64_t s = x->is_leaf ? ((Leaf*)k)->size : ((Node*)k)->size;
      const int64_t* c = x->is_leaf ? ((Leaf*)k)->cnt : ((Node*)k)->cnt;
      y->size += s;
      x->size -= s;
      for (int q = 0; q < 4; ++q) {
        y->cnt[q] += c[q];
        x->cnt[q] -= c[q];
      }
    }
    x->nkids = half;
    insert_kid(parent, at + 1, y);
  }

  void dump(uint8_t* packed) const {  // 4 codes/byte, code i at bits 2*(i&3)
    int64_t out = 0;
    dump_rec(root, packed, out);
  }
  static void dump_rec(const Node* x, uint8_t* packed, int64_t& out) {
    for (int k = 0; k < x->nkids; ++k) {
      if (x->is_leaf) {
        const Leaf* l = (const Leaf*)x->kid[k];
        for (int i = 0; i < l->size; ++i) {
          int sh = (out & 3) * 2;
          packed[out >> 2] = uint8_t(
              (packed[out >> 2] & ~(3 << sh)) | (l->get(i) << sh));
          ++out;
        }
      } else {
        dump_rec((const Node*)x->kid[k], packed, out);
      }
    }
  }
};

// static rank over the packed BWT for the LF walks
struct StaticRank {
  const uint8_t* packed;
  int64_t n;
  std::vector<int64_t> cp;  // 4 counters per 256-char block

  StaticRank(const uint8_t* p, int64_t n_) : packed(p), n(n_) {
    int64_t blocks = (n + 255) / 256;
    cp.assign((blocks + 1) * 4, 0);
    int64_t run[4] = {0, 0, 0, 0};
    for (int64_t b = 0; b < blocks; ++b) {
      for (int q = 0; q < 4; ++q) cp[b * 4 + q] = run[q];
      int64_t lo = b * 256, hi = lo + 256 < n ? lo + 256 : n;
      for (int64_t i = lo; i < hi; ++i) ++run[sym(i)];
    }
    for (int q = 0; q < 4; ++q) cp[blocks * 4 + q] = run[q];
  }
  inline int sym(int64_t i) const {
    return (packed[i >> 2] >> ((i & 3) * 2)) & 3;
  }
  int64_t rank(int c, int64_t pos) const {
    int64_t b = pos / 256;
    int64_t r = cp[b * 4 + c];
    const uint64_t* w = (const uint64_t*)(packed + b * 64);
    int64_t rem = pos - b * 256;
    int full = (int)(rem >> 5);
    // NOTE: packed is byte-addressable; u64 access is safe only when the
    // buffer is 8-byte aligned and padded -- callers allocate with numpy,
    // which guarantees both (capacity rounded up by the python wrapper).
    for (int q = 0; q < full; ++q) r += word_count(w[q], c, 32);
    if (rem & 31) r += word_rank(w[full], c, (int)(rem & 31));
    return r;
  }
};

}  // namespace

extern "C" {

// See module comment.  bwt_packed: ceil(n/4) bytes rounded up to a multiple
// of 64 and zero-initialized.  mark_bits: ceil(n/8) bytes zeroed.  samples:
// capacity >= n/sa_rate + 1.  Returns 0 on success.
int bwtinc_build(const uint8_t* text, int64_t n, int32_t sa_rate,
                 uint8_t* bwt_packed, uint8_t* mark_bits,
                 uint32_t* samples, int64_t* out_nsamples) {
  if (n <= 0 || sa_rate <= 0 || !text || !bwt_packed || !mark_bits ||
      !samples || !out_nsamples)
    return 1;
  if (text[n - 1] != 0) return 2;

  int64_t p;  // row of the full suffix (the $ row) in the final BWT
  try {
    DynBWT bwt;
    bwt.insert(0, 0);  // BWT("$") = "$"
    p = 0;
    int64_t count[4] = {0, 0, 0, 0};  // real-char counts (no $)
    for (int64_t i = n - 2; i >= 0; --i) {
      int c = text[i];
      if (c < 1 || c > 3) return 3;
      bwt.set_symbol(p, 0, c);
      int64_t r = bwt.rank(c, p);
      ++count[c];
      int64_t cbase = 1;  // the $ suffix is smaller than everything
      for (int q = 1; q < c; ++q) cbase += count[q];
      p = cbase + r;
      bwt.insert(p, 0);
    }
    bwt.dump(bwt_packed);
  } catch (const std::bad_alloc&) {
    return 4;
  }

  // LF walks over the static BWT: positions -> mark bits, then samples.
  try {
    StaticRank sr(bwt_packed, n);
    int64_t C[4];
    C[0] = 0;
    C[1] = 1;  // one $
    C[2] = C[1] + sr.cp[((n + 255) / 256) * 4 + 1];
    C[3] = C[2] + sr.cp[((n + 255) / 256) * 4 + 2];

    int64_t nmarks = 0;
    for (int pass = 0; pass < 2; ++pass) {
      // second pass needs mark-rank: block prefix counts over mark_bits
      std::vector<int64_t> mprefix;
      if (pass == 1) {
        int64_t mb = (n + 511) / 512;  // per 64-byte block of bits
        mprefix.assign(mb + 1, 0);
        for (int64_t b = 0; b < mb; ++b) {
          int64_t lo = b * 64, hi = lo + 64;
          int64_t bytes_n = (n + 7) / 8;
          if (hi > bytes_n) hi = bytes_n;
          int64_t s = 0;
          for (int64_t by = lo; by < hi; ++by)
            s += __builtin_popcount(mark_bits[by]);
          mprefix[b + 1] = mprefix[b] + s;
        }
      }
      int64_t r = p, pos = 0;
      for (int64_t step = 0; step < n; ++step) {
        if (pos % sa_rate == 0) {
          if (pass == 0) {
            mark_bits[r >> 3] |= (uint8_t)(1u << (r & 7));
            ++nmarks;
          } else {
            int64_t mrank = mprefix[r >> 9];
            for (int64_t by = (r >> 9) << 6; by < (r >> 3); ++by)
              mrank += __builtin_popcount(mark_bits[by]);
            mrank += __builtin_popcount(
                mark_bits[r >> 3] & ((1u << (r & 7)) - 1));
            samples[mrank] = (uint32_t)pos;
          }
        }
        int c = sr.sym(r);
        r = C[c] + sr.rank(c, r);
        pos = pos == 0 ? n - 1 : pos - 1;
      }
    }
    *out_nsamples = nmarks;
  } catch (const std::bad_alloc&) {
    return 4;
  }
  return 0;
}

}  // extern "C"

#ifdef BWTINC_SELFTEST
// Verified against a naive suffix sort: BWT bytes, mark bits and samples.
#include <algorithm>
#include <cstdio>

int main() {
  unsigned seed = 987;
  for (int iter = 0; iter < 40; ++iter) {
    int64_t n = 2 + rand_r(&seed) % 3000;
    int rate = 1 + rand_r(&seed) % 8;
    std::vector<uint8_t> t(n);
    for (int64_t i = 0; i + 1 < n; ++i) t[i] = 1 + rand_r(&seed) % 3;
    t[n - 1] = 0;
    std::vector<int64_t> sa(n);
    for (int64_t i = 0; i < n; ++i) sa[i] = i;
    std::sort(sa.begin(), sa.end(), [&](int64_t a, int64_t b) {
      while (a < n && b < n) {
        if (t[a] != t[b]) return t[a] < t[b];
        ++a; ++b;
      }
      return a == n;
    });
    std::vector<uint8_t> want_bwt(n);
    for (int64_t r = 0; r < n; ++r)
      want_bwt[r] = t[(sa[r] + n - 1) % n];

    std::vector<uint8_t> packed((n / 4 + 64) & ~63ULL, 0);
    std::vector<uint8_t> marks((n + 7) / 8, 0);
    std::vector<uint32_t> samples(n / rate + 2, 0);
    int64_t nm = 0;
    int rc = bwtinc_build(t.data(), n, rate, packed.data(), marks.data(),
                          samples.data(), &nm);
    if (rc != 0) { std::printf("FAIL rc=%d\n", rc); return 1; }
    int64_t mi = 0;
    for (int64_t r = 0; r < n; ++r) {
      int got = (packed[r >> 2] >> ((r & 3) * 2)) & 3;
      if (got != want_bwt[r]) { std::puts("FAIL bwt"); return 1; }
      bool want_mark = (sa[r] % rate) == 0;
      bool got_mark = (marks[r >> 3] >> (r & 7)) & 1;
      if (want_mark != got_mark) { std::puts("FAIL mark"); return 1; }
      if (want_mark) {
        if (samples[mi] != (uint32_t)sa[r]) { std::puts("FAIL sample"); return 1; }
        ++mi;
      }
    }
    if (mi != nm) { std::puts("FAIL nmarks"); return 1; }
  }
  std::puts("OK");
  return 0;
}
#endif
