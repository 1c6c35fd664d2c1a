"""The port's RoBERTa BPE tokenizer against the JAX package's, on the tiny
BPE files of tests/test_tokenizer.py and on files learned from the HICO
label texts by `tools/hico_tree.py::write_label_tokenizer`: equal ids and
masks, with and without a length cap."""

import numpy as np
import pytest

from rlipv2_tpu.utils.tokenizer import RobertaTokenizer as JaxTokenizer
from rlipv2_tpu_torch.data.text import NO_OBJ_TEXT
from rlipv2_tpu_torch.data.vocab import HICO_OBJECT_NAMES, HICO_VERB_NAMES
from rlipv2_tpu_torch.tools.hico_tree import write_label_tokenizer
from rlipv2_tpu_torch.utils.tokenizer import RobertaTokenizer
from test_tokenizer import make_assets

TEXTS = ["cat", "ride cat", "dog rides a cat", "zebra!?", "no objects", ".", "  ride   the  dog "]
LABELS = list(HICO_OBJECT_NAMES) + [NO_OBJ_TEXT] + list(HICO_VERB_NAMES) + ["."]


@pytest.mark.parametrize("max_len", [None, 4, 24])
def test_batch_encode_matches_jax(tmp_path, max_len):
    vf, mf = make_assets(tmp_path)
    got = RobertaTokenizer.from_files(vf, mf).batch_encode(TEXTS, max_len=max_len)
    want = JaxTokenizer.from_files(vf, mf).batch_encode(TEXTS, max_len=max_len)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_label_tokenizer_encodes_every_hico_label(tmp_path):
    """Learned from the labels: every label encodes without <unk>, in a few
    tokens, the same as the JAX tokenizer does, with ids far below RoBERTa's
    50265."""
    write_label_tokenizer(tmp_path, LABELS)
    ours = RobertaTokenizer.from_files(tmp_path / "vocab.json", tmp_path / "merges.txt")
    theirs = JaxTokenizer.from_files(tmp_path / "vocab.json", tmp_path / "merges.txt")
    ids, mask = ours.batch_encode(LABELS, max_len=24)
    want_ids, want_mask = theirs.batch_encode(LABELS, max_len=24)
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_array_equal(mask, want_mask)
    assert not np.any(ids == ours.unk) and ids.max() < 50265
    assert mask.sum(1).max() <= 12 and (ids[:, 0] == ours.bos).all()
