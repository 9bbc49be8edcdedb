// Native RWKV world-vocab tokenizer: greedy longest-match encode.
//
// The native counterpart of the reference's Rust tokenizer
// (ref: src/tokenizer.rs:1-171): token byte strings indexed by their
// first two bytes -> the set of candidate lengths that actually occur,
// probed longest-first against a hash map. Python builds the vocab
// tables once (utils/tokenizer.py) and hands them over as flat buffers;
// this file owns only the hot encode loop, so a multi-MB ppl corpus
// encodes in milliseconds instead of seconds.
//
// C ABI for ctypes; built by native/__init__.py with `g++ -O3`.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string>
#include <string_view>
#include <unordered_map>
#include <vector>

namespace {

struct Vocab {
  // all token byte strings, concatenated (owned)
  std::string blob;
  std::unordered_map<std::string_view, int32_t> to_id;
  // first-two-bytes key (b0 | b1<<8) -> candidate lengths, descending
  std::vector<std::vector<uint32_t>> lengths;  // 65536 slots
};

}  // namespace

extern "C" {

// entries: n token byte strings at blob[offsets[i]..offsets[i+1]), id ids[i].
// offsets has n+1 entries. Returns an opaque handle.
void* tok_build(int64_t n, const uint8_t* blob, const int64_t* offsets,
                const int32_t* ids) {
  auto* v = new Vocab();
  // guard: assign(nullptr, 0) is UB even for length 0 (empty vocab blob)
  if (blob != nullptr && offsets[n] > 0) {
    v->blob.assign(reinterpret_cast<const char*>(blob),
                   static_cast<size_t>(offsets[n]));
  }
  v->to_id.reserve(static_cast<size_t>(n) * 2);
  v->lengths.resize(65536);
  for (int64_t i = 0; i < n; i++) {
    size_t off = static_cast<size_t>(offsets[i]);
    size_t len = static_cast<size_t>(offsets[i + 1] - offsets[i]);
    std::string_view sv(v->blob.data() + off, len);
    v->to_id[sv] = ids[i];  // later entry wins, matching dict insert order
    if (len >= 2) {
      uint32_t key = static_cast<uint8_t>(sv[0]) |
                     (static_cast<uint32_t>(static_cast<uint8_t>(sv[1])) << 8);
      v->lengths[key].push_back(static_cast<uint32_t>(len));
    }
  }
  for (auto& ls : v->lengths) {
    if (ls.empty()) continue;
    ls.push_back(1);
    std::sort(ls.begin(), ls.end(), std::greater<uint32_t>());
    ls.erase(std::unique(ls.begin(), ls.end()), ls.end());
  }
  return v;
}

void tok_free(void* handle) { delete static_cast<Vocab*>(handle); }

// Greedy longest-match encode. Writes up to out_cap ids; returns the
// token count, or -(pos+1) if no token matches at byte offset pos. If
// the output would exceed out_cap, returns the required count with only
// out_cap ids written (caller re-invokes with a bigger buffer; counts
// are deterministic).
int64_t tok_encode(const void* handle, const uint8_t* text, int64_t n,
                   int32_t* out, int64_t out_cap) {
  const auto* v = static_cast<const Vocab*>(handle);
  const char* data = reinterpret_cast<const char*>(text);
  int64_t pos = 0, count = 0;
  static const std::vector<uint32_t> kOne{1};
  while (pos < n) {
    const std::vector<uint32_t>* cand = &kOne;
    if (pos + 1 < n) {
      uint32_t key = static_cast<uint8_t>(data[pos]) |
                     (static_cast<uint32_t>(static_cast<uint8_t>(data[pos + 1]))
                      << 8);
      if (!v->lengths[key].empty()) cand = &v->lengths[key];
    }
    bool matched = false;
    for (uint32_t len : *cand) {
      if (pos + static_cast<int64_t>(len) > n) continue;
      auto it = v->to_id.find(std::string_view(data + pos, len));
      if (it != v->to_id.end()) {
        if (count < out_cap) out[count] = it->second;
        count++;
        pos += len;
        matched = true;
        break;
      }
    }
    if (!matched) return -(pos + 1);
  }
  return count;
}

}  // extern "C"
