"""Text preprocessing for the federated language-modelling datasets (port
of ``fedml_tpu/data/text.py``).

Mirrors the semantics of the reference's three vocabularies:

- LEAF shakespeare char vocab (90 = 86 chars + pad/oov/bos/eos slots),
  fedml_api/data_preprocessing/shakespeare/language_utils.py:11-53;
- TFF fed_shakespeare word_dict ([pad] + chars + [bos] + [eos]),
  fedml_api/data_preprocessing/fed_shakespeare/utils.py:23-77;
- TFF stackoverflow next-word-prediction tokenizer (10k words + pad/bos/eos
  + oov bucket => vocab 10004) and the tag-prediction bag-of-words encoder,
  fedml_api/data_preprocessing/stackoverflow_nwp/utils.py:56-90 and
  stackoverflow_lr/utils.py:66-101.

Everything returns numpy int32 arrays; no one-hot on the host —
embedding lookup happens on device.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

# TFF text-generation tutorial vocabulary (86 chars), identical ordering.
CHAR_VOCAB = list(
    'dhlptx@DHLPTX $(,048cgkoswCGKOSW[_#\'/37;?bfjnrvzBFJNRVZ"&*.26:\naeimquyAEIMQUY]!%)-159\r'
)
ALL_LETTERS = "".join(CHAR_VOCAB)
# pad=0 ... + oov, bos, eos slots → 90, matching RNN_OriginalFedAvg's vocab
# (model/nlp/rnn.py:4 embedding size 90).
VOCAB_SIZE = len(ALL_LETTERS) + 4

SHAKESPEARE_SEQ_LEN = 80  # McMahan et al. AISTATS'17 window

PAD, BOS, EOS = "<pad>", "<bos>", "<eos>"


def letter_to_index(letter: str) -> int:
    """LEAF-style: position in ALL_LETTERS, -1 for unknown."""
    return ALL_LETTERS.find(letter)


def word_to_indices(word: str) -> List[int]:
    return [ALL_LETTERS.find(c) for c in word]


def shakespeare_word_dict() -> Dict[str, int]:
    """TFF fed_shakespeare dict: [pad] + CHAR_VOCAB + [bos] + [eos]."""
    words = [PAD] + CHAR_VOCAB + [BOS] + [EOS]
    return {w: i for i, w in enumerate(words)}


def shakespeare_char_to_id(char: str, word_dict: Dict[str, int] | None = None) -> int:
    wd = word_dict or shakespeare_word_dict()
    return wd.get(char, len(wd))  # oov bucket = len(dict)


def shakespeare_preprocess(
    sentences: Sequence[str], max_seq_len: int = SHAKESPEARE_SEQ_LEN
) -> np.ndarray:
    """TFF-style: bos + char ids (+ eos if short) padded to max_seq_len+1.

    Returns [n, max_seq_len+1] int32; split x = [:, :-1], y = [:, 1:] for
    next-char prediction (fed_shakespeare/utils.py:52-77).
    """
    wd = shakespeare_word_dict()
    bos, eos, pad = wd[BOS], wd[EOS], wd[PAD]
    out = []
    for s in sentences:
        ids = [shakespeare_char_to_id(c, wd) for c in s[:max_seq_len]]
        if len(ids) < max_seq_len:
            ids = ids + [eos]
        ids = [bos] + ids
        ids += [pad] * (max_seq_len + 1 - len(ids))
        out.append(ids[: max_seq_len + 1])
    return np.asarray(out, dtype=np.int32)


def leaf_shakespeare_encode(snippets: Sequence[str], targets: Sequence[str]) -> tuple:
    """LEAF shakespeare: 80-char snippet → indices; targets are the FULL
    shifted sequence (next char at every position — x[1:] + the LEAF next
    char), training the LSTM on all 80 positions instead of only the last.
    Unknown chars index to -1, which the seq loss masks out (pad_id=-1)."""
    x = np.asarray([word_to_indices(s) for s in snippets], dtype=np.int32)
    nxt = np.asarray(
        [letter_to_index(t[0]) if t else -1 for t in targets], dtype=np.int32
    )
    y = np.concatenate([x[:, 1:], nxt[:, None]], axis=1)
    return x, y


class StackOverflowVocab:
    """NWP tokenizer: [pad] + top-k words + [bos] + [eos], 1 oov bucket.

    ``words`` is the frequency-sorted word list (stackoverflow.word_count in
    the reference's data dir; any list in tests).
    """

    def __init__(self, words: Sequence[str], num_oov_buckets: int = 1):
        self.word_dict = {PAD: 0}
        for w in words:
            self.word_dict[w] = len(self.word_dict)
        self.word_dict[BOS] = len(self.word_dict)
        self.word_dict[EOS] = len(self.word_dict)
        self.num_oov_buckets = num_oov_buckets

    @property
    def vocab_size(self) -> int:  # e.g. 10000 + 3 + 1 = 10004
        return len(self.word_dict) + self.num_oov_buckets

    def word_to_id(self, word: str) -> int:
        if word in self.word_dict:
            return self.word_dict[word]
        return hash(word) % self.num_oov_buckets + len(self.word_dict)

    def tokenize(self, sentence: str, max_seq_len: int = 20) -> List[int]:
        tokens = [self.word_to_id(t) for t in sentence.split(" ")[:max_seq_len]]
        if len(tokens) < max_seq_len:
            tokens = tokens + [self.word_dict[EOS]]
        tokens = [self.word_dict[BOS]] + tokens
        tokens += [self.word_dict[PAD]] * (max_seq_len + 1 - len(tokens))
        return tokens[: max_seq_len + 1]

    def encode_nwp(self, sentences: Sequence[str], max_seq_len: int = 20):
        """[n, L] inputs, [n, L] next-word targets (nwp/utils.py:85-90 splits
        last column only; we keep the full shifted sequence for the LSTM
        and the caller may slice)."""
        ids = np.asarray([self.tokenize(s, max_seq_len) for s in sentences], np.int32)
        return ids[:, :-1], ids[:, 1:]


def bag_of_words(
    sentences: Sequence[str], word_dict: Dict[str, int], normalize: bool = True
) -> np.ndarray:
    """stackoverflow_lr input encoding: mean one-hot over tokens incl. one
    oov slot (stackoverflow_lr/utils.py:66-101)."""
    v = len(word_dict)
    out = np.zeros((len(sentences), v + 1), dtype=np.float32)
    for i, s in enumerate(sentences):
        toks = [word_dict.get(t, v) for t in s.split(" ")]
        for t in toks:
            out[i, t] += 1.0
        if normalize and toks:
            out[i] /= len(toks)
    return out


def bag_of_tags(tag_lists: Sequence[Sequence[str]], tag_dict: Dict[str, int]) -> np.ndarray:
    """Multi-hot tag targets (stackoverflow_lr/utils.py preprocess_targets)."""
    out = np.zeros((len(tag_lists), len(tag_dict)), dtype=np.float32)
    for i, tags in enumerate(tag_lists):
        for t in tags:
            if t in tag_dict:
                out[i, tag_dict[t]] = 1.0
    return out
