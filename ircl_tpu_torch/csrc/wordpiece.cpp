// WordPiece pair encoder for ASCII pairs, a host library of the port.
//
// Built with g++ by utils/native_build.py (lib "wordpiece") into
// ircl_tpu_torch/_build/libircl_wordpiece.so and loaded with ctypes by
// models/wordpiece.py, whose WordPieceTokenizer.encode_batch sends it every
// pair whose texts are both ASCII.
//
// Reproduces, bit for bit, WordPieceTokenizer.encode_pair: SimpleTokenizer
// words lowercased (its ASCII split below), greedy longest-match pieces with
// "##" continuations, [UNK] for a word over max_input_chars characters or with
// a part no piece matches, longest-first truncation, [CLS] a [SEP] (b [SEP])
// and [PAD] padding. The vocabulary table is built once; the encoder only
// reads it, so concurrent callers may share one handle.

#include <algorithm>
#include <cstdint>
#include <string>
#include <string_view>
#include <unordered_map>
#include <vector>

namespace {

// SimpleTokenizer's ALPHA_NUM ([\p{L}\p{N}\p{M}]) restricted to ASCII.
inline bool is_alnum_ascii(uint8_t c) {
  return (c >= '0' && c <= '9') || (c >= 'a' && c <= 'z') ||
         (c >= 'A' && c <= 'Z');
}

// ASCII \p{Z} is ' ' (0x20); \p{C} is 0x00-0x1f and 0x7f. Every other ASCII
// character is a word of its own (SimpleTokenizer's NON_WS).
inline bool is_ws_or_ctrl(uint8_t c) { return c <= 0x20 || c == 0x7f; }

struct WordPieceVocab {
  std::string keys;  // every key back to back; the map's views point here
  std::unordered_map<std::string_view, int32_t> ids;
  int64_t max_key = 0;  // no candidate longer than this can match
};

// Appends the piece ids of one lowercased word to out, or one unk.
void word_pieces(const WordPieceVocab& v, const std::string& word,
                 int64_t max_chars, int32_t unk, std::string& cand,
                 std::vector<int32_t>& out) {
  const int64_t n = static_cast<int64_t>(word.size());
  if (n > max_chars) {
    out.push_back(unk);
    return;
  }
  const size_t first = out.size();
  int64_t start = 0;
  while (start < n) {
    // candidates are prefixes of word[start:], "##"-marked after the start
    const int64_t pre = start > 0 ? 2 : 0;
    cand.assign(start > 0 ? "##" : "");
    cand.append(word, static_cast<size_t>(start), std::string::npos);
    int64_t len = std::min<int64_t>(static_cast<int64_t>(cand.size()), v.max_key);
    for (; len > pre; len--) {
      auto it = v.ids.find(std::string_view(cand.data(), static_cast<size_t>(len)));
      if (it != v.ids.end()) {
        out.push_back(it->second);
        break;
      }
    }
    if (len <= pre) {
      out.resize(first);
      out.push_back(unk);
      return;
    }
    start += len - pre;
  }
}

// The pieces of one ASCII text, at most cap of them: each word's pieces are
// found whole (an unmatched part turns the whole word to unk) before the cut.
void text_pieces(const WordPieceVocab& v, const uint8_t* s, int64_t len,
                 int64_t cap, int64_t max_chars, int32_t unk, std::string& word,
                 std::string& cand, std::vector<int32_t>& out) {
  out.clear();
  int64_t i = 0;
  while (i < len && static_cast<int64_t>(out.size()) < cap) {
    const uint8_t c = s[i];
    if (is_alnum_ascii(c)) {
      word.clear();
      while (i < len && is_alnum_ascii(s[i])) {
        uint8_t ch = s[i];
        if (ch >= 'A' && ch <= 'Z') ch += 32;
        word.push_back(static_cast<char>(ch));
        i++;
      }
    } else if (!is_ws_or_ctrl(c)) {
      word.assign(1, static_cast<char>(c));
      i++;
    } else {
      i++;
      continue;
    }
    word_pieces(v, word, max_chars, unk, cand, out);
  }
  if (static_cast<int64_t>(out.size()) > cap) out.resize(static_cast<size_t>(cap));
}

}  // namespace

extern "C" {

// A table of n vocabulary keys (packed back to back, offsets of length n+1)
// and their ids; free it with ircl_wordpiece_vocab_free.
void* ircl_wordpiece_vocab_new(const char* packed, const int64_t* offsets,
                               const int32_t* ids, int64_t n) {
  auto* v = new WordPieceVocab;
  v->keys.assign(packed, static_cast<size_t>(offsets[n]));
  v->ids.reserve(static_cast<size_t>(n));
  for (int64_t i = 0; i < n; i++) {
    const int64_t len = offsets[i + 1] - offsets[i];
    v->ids.emplace(std::string_view(v->keys.data() + offsets[i], static_cast<size_t>(len)),
                   ids[i]);
    v->max_key = std::max(v->max_key, len);
  }
  return v;
}

void ircl_wordpiece_vocab_free(void* handle) {
  delete static_cast<WordPieceVocab*>(handle);
}

// Encode n_pairs ASCII pairs: text a of pair r is packed[offsets[2r],
// offsets[2r+1]), text b the next span (empty for no second text). Writes
// every element of out_ids, out_mask and out_types, each [n_pairs,
// max_length] (max_length >= 2).
void ircl_wordpiece_encode_pairs(const void* handle, const char* packed,
                                 const int64_t* offsets, int64_t n_pairs,
                                 int64_t max_length, int64_t max_input_chars,
                                 int32_t unk_id, int32_t cls_id, int32_t sep_id,
                                 int32_t pad_id, int32_t* out_ids,
                                 float* out_mask, int32_t* out_types) {
  const auto& v = *static_cast<const WordPieceVocab*>(handle);
  const uint8_t* base = reinterpret_cast<const uint8_t*>(packed);
  // the budget below is never above this, so no piece past it survives
  const int64_t cap = std::max<int64_t>(max_length - 2, 0);
  std::vector<int32_t> ta, tb;
  std::string word, cand;
  for (int64_t r = 0; r < n_pairs; r++) {
    const int64_t* o = offsets + 2 * r;
    text_pieces(v, base + o[0], o[1] - o[0], cap, max_input_chars, unk_id, word, cand, ta);
    text_pieces(v, base + o[1], o[2] - o[1], cap, max_input_chars, unk_id, word, cand, tb);
    // longest-first truncation; starting a side at the budget ends where its
    // full length would, since the longer side is cut first either way
    const int64_t budget = std::max<int64_t>(max_length - (tb.empty() ? 2 : 3), 0);
    int64_t la = std::min<int64_t>(static_cast<int64_t>(ta.size()), budget);
    int64_t lb = std::min<int64_t>(static_cast<int64_t>(tb.size()), budget);
    while (la + lb > budget) {
      if (la >= lb)
        la--;
      else
        lb--;
    }
    int32_t* ids = out_ids + r * max_length;
    float* mask = out_mask + r * max_length;
    int32_t* types = out_types + r * max_length;
    int64_t k = 0;
    auto put = [&](int32_t id, int32_t type) {
      ids[k] = id;
      mask[k] = 1.0f;
      types[k] = type;
      k++;
    };
    put(cls_id, 0);
    for (int64_t i = 0; i < la; i++) put(ta[i], 0);
    put(sep_id, 0);
    if (lb > 0) {
      for (int64_t i = 0; i < lb; i++) put(tb[i], 1);
      put(sep_id, 1);
    }
    for (; k < max_length; k++) {
      ids[k] = pad_id;
      mask[k] = 0.0f;
      types[k] = 0;
    }
  }
}

}  // extern "C"
