"""Pure-Python tokenizers, as ``mtvaf_tpu.data.tokenization`` implements
them: WordPiece (BasicTokenizer + greedy longest-match WordPiece over a
BERT ``vocab.txt``) and RoBERTa's byte-level BPE (``vocab.json`` +
``merges.txt``)."""

from __future__ import annotations

import collections
import json
import os
import re
import unicodedata
from typing import Dict, Iterable, List


def load_vocab(vocab_file: str) -> Dict[str, int]:
    """Load a BERT vocab.txt (one token per line) into an ordered dict."""
    vocab = collections.OrderedDict()
    with open(vocab_file, "r", encoding="utf-8") as f:
        for idx, line in enumerate(f):
            vocab[line.rstrip("\n")] = idx
    return vocab


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    # ASCII ranges count as punctuation even where unicode disagrees ("$",
    # "^", ...), as in the Google tokenizer.
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) \
            or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_chinese_char(cp: int) -> bool:
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
            or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
            or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
            or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F)


def whitespace_tokenize(text: str) -> List[str]:
    text = text.strip()
    return text.split() if text else []


DEFAULT_NEVER_SPLIT = ("[UNK]", "[SEP]", "[PAD]", "[CLS]", "[MASK]")


class BasicTokenizer:
    """Whitespace/punctuation splitting, lowercasing, accent stripping;
    special tokens in ``never_split`` stay whole."""

    def __init__(self, do_lower_case: bool = True,
                 never_split=DEFAULT_NEVER_SPLIT):
        self.do_lower_case = do_lower_case
        self.never_split = set(never_split or ())

    def tokenize(self, text: str) -> List[str]:
        text = self._clean_text(text)
        text = self._tokenize_chinese_chars(text)
        split_tokens: List[str] = []
        for token in whitespace_tokenize(text):
            if token in self.never_split:
                split_tokens.append(token)
                continue
            if self.do_lower_case:
                token = self._strip_accents(token.lower())
            split_tokens.extend(self._split_on_punc(token))
        return whitespace_tokenize(" ".join(split_tokens))

    @staticmethod
    def _clean_text(text: str) -> str:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            out.append(" " if _is_whitespace(ch) else ch)
        return "".join(out)

    @staticmethod
    def _strip_accents(text: str) -> str:
        text = unicodedata.normalize("NFD", text)
        return "".join(ch for ch in text if unicodedata.category(ch) != "Mn")

    @staticmethod
    def _split_on_punc(text: str) -> List[str]:
        output: List[List[str]] = []
        start_new_word = True
        for ch in text:
            if _is_punctuation(ch):
                output.append([ch])
                start_new_word = True
            else:
                if start_new_word:
                    output.append([])
                start_new_word = False
                output[-1].append(ch)
        return ["".join(x) for x in output]

    @staticmethod
    def _tokenize_chinese_chars(text: str) -> str:
        out = []
        for ch in text:
            if _is_chinese_char(ord(ch)):
                out.extend((" ", ch, " "))
            else:
                out.append(ch)
        return "".join(out)


class WordpieceTokenizer:
    """Greedy longest-match-first WordPiece."""

    def __init__(self, vocab: Dict[str, int], unk_token: str = "[UNK]",
                 max_input_chars_per_word: int = 100):
        self.vocab = vocab
        self.unk_token = unk_token
        self.max_input_chars_per_word = max_input_chars_per_word

    def tokenize(self, text: str) -> List[str]:
        output_tokens: List[str] = []
        for token in whitespace_tokenize(text):
            if len(token) > self.max_input_chars_per_word:
                output_tokens.append(self.unk_token)
                continue
            start = 0
            sub_tokens: List[str] = []
            while start < len(token):
                end = len(token)
                cur_substr = None
                while start < end:
                    substr = token[start:end]
                    if start > 0:
                        substr = "##" + substr
                    if substr in self.vocab:
                        cur_substr = substr
                        break
                    end -= 1
                if cur_substr is None:
                    sub_tokens = None
                    break
                sub_tokens.append(cur_substr)
                start = end
            if sub_tokens is None:
                output_tokens.append(self.unk_token)
            else:
                output_tokens.extend(sub_tokens)
        return output_tokens


class FullTokenizer:
    """BasicTokenizer + WordPiece over a vocab file."""

    unk_token = "[UNK]"

    def __init__(self, vocab, do_lower_case: bool = True):
        if isinstance(vocab, str):
            vocab = load_vocab(vocab)
        self.vocab = vocab
        self.basic_tokenizer = BasicTokenizer(do_lower_case=do_lower_case)
        self.wordpiece_tokenizer = WordpieceTokenizer(vocab=vocab)

    def tokenize(self, text: str) -> List[str]:
        split_tokens: List[str] = []
        for token in self.basic_tokenizer.tokenize(text):
            split_tokens.extend(self.wordpiece_tokenizer.tokenize(token))
        return split_tokens

    def convert_tokens_to_ids(self, tokens: Iterable[str]) -> List[int]:
        unk = self.vocab.get(self.unk_token, 0)
        return [self.vocab.get(t, unk) for t in tokens]


# ---------------------------------------------------------------------------
# Byte-level BPE (RoBERTa).


def _bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte → unicode character mapping."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


class ByteLevelBPETokenizer:
    """GPT-2/RoBERTa byte-level BPE over ``vocab.json`` + ``merges.txt``."""

    cls_token = "<s>"
    sep_token = "</s>"
    pad_token = "<pad>"
    unk_token = "<unk>"

    def __init__(self, vocab_file: str, merges_file: str):
        with open(vocab_file, encoding="utf-8") as f:
            self.vocab: Dict[str, int] = json.load(f)
        with open(merges_file, encoding="utf-8") as f:
            merges = [tuple(line.split()) for line in f.read().split("\n")
                      if line and not line.startswith("#version")]
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.byte_encoder = _bytes_to_unicode()
        self.cache: Dict[str, str] = {}
        self.pat = re.compile(
            r"""'s|'t|'re|'ve|'m|'ll|'d| ?\w+| ?[^\s\w]+|\s+(?!\S)|\s+""",
            re.UNICODE)

    def _bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token)
        pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
        if not pairs:
            return token
        while True:
            bigram = min(pairs,
                         key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first \
                        and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
        out = " ".join(word)
        self.cache[token] = out
        return out

    def tokenize(self, text: str) -> List[str]:
        bpe_tokens: List[str] = []
        for token in self.pat.findall(text):
            token_trans = "".join(self.byte_encoder[b]
                                  for b in token.encode("utf-8"))
            bpe_tokens.extend(self._bpe(token_trans).split(" "))
        return bpe_tokens

    def convert_tokens_to_ids(self, tokens: Iterable[str]) -> List[int]:
        unk = self.vocab.get(self.unk_token, 0)
        return [self.vocab.get(t, unk) for t in tokens]


def build_tokenizer(bert_name: str, do_lower_case: bool = True):
    """The tokenizer of a local model directory: RoBERTa's byte-level BPE
    (``vocab.json`` + ``merges.txt``) when "roberta" is in the name, as the
    reference dispatches (modules/dataset.py:20-23), else WordPiece over
    ``vocab.txt``."""
    if "roberta" in bert_name:
        files = [os.path.join(bert_name, n)
                 for n in ("vocab.json", "merges.txt")]
        if not all(os.path.isfile(p) for p in files):
            raise ValueError(f"cannot build a tokenizer for {bert_name!r}: "
                             "no vocab.json and merges.txt in that "
                             "directory")
        return ByteLevelBPETokenizer(*files)
    path = os.path.join(bert_name, "vocab.txt")
    if not os.path.isfile(path):
        raise ValueError(f"cannot build a tokenizer for {bert_name!r}: no "
                         f"vocab.txt in that directory")
    return FullTokenizer(path, do_lower_case)
