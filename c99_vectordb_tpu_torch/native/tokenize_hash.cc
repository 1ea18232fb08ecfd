// Native bulk tokenizer + FNV-1a feature hasher.
//
// The host-side hot loop of index builds (SURVEY.md §3.1/§3.4): turning a
// corpus of record bodies into (bucket, sign) feature streams for the
// batched device embedder (ops/embed.py). Python-level tokenization costs
// microseconds per token; at millions of records that dominates the
// host-side build time, so this mirrors utils/hashing.py in C++ behind a
// plain C ABI (loaded via ctypes — no pybind11 dependency).
//
// Semantics (must match utils/hashing.py exactly for ASCII input; the
// Python binding routes non-ASCII strings to the Python path):
//   token  := maximal run of [A-Za-z0-9_] bytes, A-Z lowercased
//   h      := FNV-1a 64-bit over the token's bytes
//   bucket := h % dim ; sign := (h & 1) ? +1.0 : -1.0
//
// Two-pass API over a concatenated UTF-8 buffer with document offsets:
//   th_count_tokens  -> per-document token counts (for exact allocation)
//   th_hash_tokens   -> fills buckets/signs/rows in document order

#include <cstdint>
#include <cstddef>

namespace {

constexpr uint64_t kFnvOffset = 0xcbf29ce484b1a325ULL;
constexpr uint64_t kFnvPrime = 0x100000001b3ULL;

inline bool is_token_byte(unsigned char c) {
  return (c >= 'a' && c <= 'z') || (c >= 'A' && c <= 'Z') ||
         (c >= '0' && c <= '9') || c == '_';
}

inline unsigned char lower(unsigned char c) {
  return (c >= 'A' && c <= 'Z') ? static_cast<unsigned char>(c + 32) : c;
}

}  // namespace

extern "C" {

// Counts tokens per document. `offsets` has n_docs+1 entries delimiting each
// document inside `buf`. Writes counts into `out_counts` (n_docs entries).
void th_count_tokens(const char* buf, const int64_t* offsets, int64_t n_docs,
                     int64_t* out_counts) {
  for (int64_t d = 0; d < n_docs; ++d) {
    const char* p = buf + offsets[d];
    const char* end = buf + offsets[d + 1];
    int64_t count = 0;
    while (p < end) {
      if (is_token_byte(static_cast<unsigned char>(*p))) {
        ++count;
        while (p < end && is_token_byte(static_cast<unsigned char>(*p))) ++p;
      } else {
        ++p;
      }
    }
    out_counts[d] = count;
  }
}

// Hashes every token. Output arrays must hold the total token count from
// th_count_tokens. `out_rows[i]` is the document index of feature i.
void th_hash_tokens(const char* buf, const int64_t* offsets, int64_t n_docs,
                    int32_t dim, int32_t* out_buckets, float* out_signs,
                    int32_t* out_rows) {
  int64_t w = 0;
  for (int64_t d = 0; d < n_docs; ++d) {
    const char* p = buf + offsets[d];
    const char* end = buf + offsets[d + 1];
    while (p < end) {
      unsigned char c = static_cast<unsigned char>(*p);
      if (!is_token_byte(c)) {
        ++p;
        continue;
      }
      uint64_t h = kFnvOffset;
      while (p < end && is_token_byte(static_cast<unsigned char>(*p))) {
        h ^= lower(static_cast<unsigned char>(*p));
        h *= kFnvPrime;
        ++p;
      }
      out_buckets[w] = static_cast<int32_t>(h % static_cast<uint64_t>(dim));
      out_signs[w] = (h & 1ULL) ? 1.0f : -1.0f;
      out_rows[w] = static_cast<int32_t>(d);
      ++w;
    }
  }
}

int32_t th_abi_version() { return 1; }

}  // extern "C"
