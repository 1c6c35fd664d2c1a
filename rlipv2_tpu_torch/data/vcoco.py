"""V-COCO in the HOIA format (counterpart of rlipv2_tpu/data/vcoco.py;
reference datasets/vcoco.py:20-207).

The HICO pipeline (`data/hico.py`) with V-COCO's 29 action-role classes,
0-based in the annotations, and their label texts. A GT `object_id` of -1
is a subject-only action ("stand", "smile", ...): in train it becomes a
pair with the no-object label and an all-zero object box, whose box terms
the matcher and the criterion mask; in val the -1 stays in `hois` for
`eval/vcoco_eval.py`. The JAX dataset's `names_file` (other label texts),
which no caller sets, is not carried over.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

from rlipv2_tpu_torch.data.hico import HICODataset
from rlipv2_tpu_torch.data.transforms import HOITransform
from rlipv2_tpu_torch.data.vocab import HICO_OBJECT_NAMES, VCOCO_VERB_NAMES


class VCOCODataset(HICODataset):
    allow_no_object_pairs = True
    num_verb_classes = len(VCOCO_VERB_NAMES)

    def __init__(self, image_set: str, img_folder, anno_file, num_queries: int = 100,
                 transforms: Optional[HOITransform] = None, device="cuda"):
        super().__init__(image_set, img_folder, anno_file, num_queries, transforms, device=device)
        self.object_text, self.verb_text = list(HICO_OBJECT_NAMES), list(VCOCO_VERB_NAMES)

    def _verb_index(self, category_id: int) -> int:
        return int(category_id)


def build_vcoco(image_set: str, hoi_path, num_queries: int = 100, device="cuda",
                transforms: Optional[HOITransform] = None) -> VCOCODataset:
    """The train or val split of the V-COCO tree at `hoi_path`
    (images/{train2014,val2014}, annotations/{trainval,test}_vcoco.json,
    and the val split's annotations/corre_vcoco.npy when it is there)."""
    root = Path(hoi_path)
    if image_set == "train":
        img_folder, anno_file = root / "images" / "train2014", root / "annotations" / "trainval_vcoco.json"
    elif image_set == "val":
        img_folder, anno_file = root / "images" / "val2014", root / "annotations" / "test_vcoco.json"
    else:
        raise ValueError(f"image_set is 'train' or 'val', not {image_set!r}")
    ds = VCOCODataset(image_set, img_folder, anno_file, num_queries, transforms, device)
    mat = root / "annotations" / "corre_vcoco.npy"
    if image_set == "val" and mat.exists():
        ds.load_correct_mat(mat)
    return ds
