// Native batch WordPiece tokenizer.
//
// Host-side hot path for dataset preparation: greedy longest-match-first
// WordPiece over a vocab hash map, with the Google-style basic tokenization
// (lowercase, ASCII punctuation split, whitespace collapse) for the ASCII
// fast path.  Words containing non-ASCII bytes are flagged so the Python
// binding can route them through the reference Python tokenizer (exact
// Unicode category handling without an ICU dependency).
//
// C ABI (used via ctypes from mtvaf_tpu_torch/native/binding.py):
//   wp_create(vocab_blob, lower)  -> handle     (vocab: '\n'-joined tokens)
//   wp_free(handle)
//   wp_encode_words(handle, words_blob, n_words, out_ids, out_word_start,
//                   max_out) -> n_tokens or -1-needed
//     words_blob: '\n'-joined already-whitespace-split words;
//     out_ids[i]: vocab id of subtoken i; out_word_start[w]: index of the
//     first subtoken of word w (n_words+1 entries, last = n_tokens).
//     Non-ASCII or unmatched words emit [UNK].

#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Tokenizer {
  std::unordered_map<std::string, int> vocab;
  int unk_id = 0;
  bool lower = true;
  int max_chars_per_word = 100;
};

inline bool is_ascii_punct(unsigned char c) {
  return (c >= 33 && c <= 47) || (c >= 58 && c <= 64) ||
         (c >= 91 && c <= 96) || (c >= 123 && c <= 126);
}

// Split one raw word into basic tokens (lowercase + punct split), ASCII only.
void basic_split(const std::string& word, bool lower,
                 std::vector<std::string>* out) {
  std::string cur;
  for (unsigned char c : word) {
    if (c <= 32) {  // control/space inside a "word" — treat as separator
      if (!cur.empty()) { out->push_back(cur); cur.clear(); }
      continue;
    }
    if (is_ascii_punct(c)) {
      if (!cur.empty()) { out->push_back(cur); cur.clear(); }
      out->push_back(std::string(1, (char)c));
    } else {
      cur.push_back(lower && c >= 'A' && c <= 'Z' ? (char)(c + 32) : (char)c);
    }
  }
  if (!cur.empty()) out->push_back(cur);
}

// Greedy longest-match WordPiece for one basic token.
void wordpiece(const Tokenizer& t, const std::string& token,
               std::vector<int>* ids) {
  if ((int)token.size() > t.max_chars_per_word) {
    ids->push_back(t.unk_id);
    return;
  }
  std::vector<int> sub;
  size_t start = 0;
  while (start < token.size()) {
    size_t end = token.size();
    int cur = -1;
    while (start < end) {
      std::string substr = token.substr(start, end - start);
      if (start > 0) substr = "##" + substr;
      auto it = t.vocab.find(substr);
      if (it != t.vocab.end()) { cur = it->second; break; }
      --end;
    }
    if (cur < 0) { ids->push_back(t.unk_id); return; }
    sub.push_back(cur);
    start = end;
  }
  ids->insert(ids->end(), sub.begin(), sub.end());
}

}  // namespace

extern "C" {

void* wp_create(const char* vocab_blob, int lower) {
  auto* t = new Tokenizer();
  t->lower = lower != 0;
  const char* p = vocab_blob;
  int idx = 0;
  while (*p) {
    const char* nl = strchr(p, '\n');
    size_t len = nl ? (size_t)(nl - p) : strlen(p);
    std::string tok(p, len);
    t->vocab.emplace(tok, idx);
    if (tok == "[UNK]") t->unk_id = idx;
    ++idx;
    if (!nl) break;
    p = nl + 1;
  }
  return t;
}

void wp_free(void* handle) { delete static_cast<Tokenizer*>(handle); }

int wp_encode_words(void* handle, const char* words_blob, int n_words,
                    int32_t* out_ids, int32_t* out_word_start, int max_out) {
  const Tokenizer& t = *static_cast<Tokenizer*>(handle);
  std::vector<int> ids;
  ids.reserve(256);
  const char* p = words_blob;
  for (int w = 0; w < n_words; ++w) {
    out_word_start[w] = (int32_t)ids.size();
    const char* nl = strchr(p, '\n');
    size_t len = nl ? (size_t)(nl - p) : strlen(p);
    std::string word(p, len);
    p = nl ? nl + 1 : p + len;

    bool ascii = true;
    for (unsigned char c : word)
      if (c >= 128) { ascii = false; break; }
    if (!ascii || word.empty()) {
      // Binding routes non-ASCII through the Python tokenizer; standalone use
      // degrades to [UNK].
      if (!word.empty()) ids.push_back(t.unk_id);
      continue;
    }
    std::vector<std::string> basic;
    basic_split(word, t.lower, &basic);
    for (const auto& b : basic) wordpiece(t, b, &ids);
  }
  out_word_start[n_words] = (int32_t)ids.size();
  if ((int)ids.size() > max_out) return -1 - (int)ids.size();
  for (size_t i = 0; i < ids.size(); ++i) out_ids[i] = ids[i];
  return (int)ids.size();
}

}  // extern "C"
