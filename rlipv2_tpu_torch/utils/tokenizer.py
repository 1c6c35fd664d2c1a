"""Byte-level BPE tokenizer, RoBERTa's scheme, in numpy (a copy of
rlipv2_tpu/utils/tokenizer.py:49-137; the port imports nothing of the JAX
package).

The reference tokenizes label texts with HF RobertaTokenizerFast
(reference: models/dab_deformable/deformable_transformer.py:334-337,
engine.py:372-373). This implements the same public algorithm (byte-level
BPE with the GPT-2 unicode byte mapping and RoBERTa's <s>/</s> special
tokens) over standard vocab.json + merges.txt files, with no transformers
dependency.
"""

from __future__ import annotations

import json
from functools import lru_cache
from pathlib import Path
from typing import Sequence

import numpy as np


@lru_cache()
def bytes_to_unicode():
    """GPT-2's reversible byte <-> unicode mapping (public algorithm)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


class RobertaTokenizer:
    """Minimal RobertaTokenizer: encode only (the framework never decodes).

    Special ids follow RoBERTa: <s>=0, <pad>=1, </s>=2, <unk>=3."""

    def __init__(self, vocab: dict, merges: Sequence[tuple[str, str]]):
        self.encoder = dict(vocab)
        self.bpe_ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.cache: dict[str, list] = {}
        self.bos = self.encoder.get("<s>", 0)
        self.eos = self.encoder.get("</s>", 2)
        self.pad = self.encoder.get("<pad>", 1)
        self.unk = self.encoder.get("<unk>", 3)

    @classmethod
    def from_files(cls, vocab_file, merges_file):
        vocab = json.loads(Path(vocab_file).read_text())
        merges = []
        for line in Path(merges_file).read_text().splitlines():
            if line.startswith("#version") or not line.strip():
                continue
            merges.append(tuple(line.split()))
        return cls(vocab, merges)

    def bpe(self, token: str) -> list:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token)
        pairs = get_pairs(word) if len(word) > 1 else set()
        while pairs:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        out = list(word)
        self.cache[token] = out
        return out

    def _words(self, text: str):
        """GPT-2 style pre-tokenization; labels are simple lowercase words,
        so whitespace splitting with leading-space marking suffices and
        matches the HF fast tokenizer on this domain."""
        words = text.strip().split()
        for i, w in enumerate(words):
            yield (" " + w) if i > 0 else w

    def encode(self, text: str) -> list:
        ids = []
        for word in self._words(text):
            token = "".join(self.byte_encoder[b] for b in word.encode("utf-8"))
            for piece in self.bpe(token):
                ids.append(self.encoder.get(piece, self.unk))
        return ids

    def batch_encode(self, texts: Sequence[str], max_len: int | None = None):
        """-> (input_ids (N, T), attention_mask (N, T)) padded 'longest',
        matching tokenizer.batch_encode_plus(padding='longest')."""
        seqs = [[self.bos] + self.encode(t) + [self.eos] for t in texts]
        T = max(len(s) for s in seqs)
        if max_len is not None:
            T = min(T, max_len)
            seqs = [s[:T] for s in seqs]
        ids = np.full((len(seqs), T), self.pad, np.int32)
        mask = np.zeros((len(seqs), T), np.int32)
        for i, s in enumerate(seqs):
            ids[i, : len(s)] = s
            mask[i, : len(s)] = 1
        return ids, mask
