"""Open Images v6 scene-graph data in the HICO format (counterpart of
rlipv2_tpu/data/oi_sgg.py; reference datasets/oi_sgg.py:32-412).

The HICO pipeline (`data/hico.py`) over `rel_annotations`, with the
categories file's 288 object and 30 relation names. The annotations' object
`category_id`s index the larger list of categories_dict.json ("obj"), and
are remapped to the 288 through it; relation ids are 0-based already.
Subjects are boxes of any class; their train label is the subject
category 0, as in the JAX package (ROADMAP queue 3).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

from rlipv2_tpu_torch.data.hico import HICODataset
from rlipv2_tpu_torch.data.transforms import HOITransform


class OISGGDataset(HICODataset):
    rel_key = "rel_annotations"
    num_verb_classes = 30

    def __init__(self, image_set: str, img_folder, anno_file, categories_dict_file, categories_dict_all_objs_file,
                 num_queries: int = 100, transforms: Optional[HOITransform] = None, device="cuda"):
        cats = json.loads(Path(categories_dict_file).read_text())
        all_objs = json.loads(Path(categories_dict_all_objs_file).read_text())["obj"]
        self._valid_obj_ids = [all_objs.index(o) for o in cats["obj"]]
        super().__init__(image_set, img_folder, anno_file, num_queries, transforms, device=device)
        self.object_text, self.verb_text = list(cats["obj"]), list(cats["rel"])

    def _obj_index(self, category_id: int) -> int:
        return self._valid_obj_ids.index(category_id)

    def _verb_index(self, category_id: int) -> int:
        return int(category_id)


def build_oi_sgg(image_set: str, sgg_path, num_queries: int = 100, device="cuda",
                 transforms: Optional[HOITransform] = None) -> OISGGDataset:
    """The train or val split of the OI-SGG tree at `sgg_path` (images/,
    annotations/oi_sgg_{train,test}.json,
    annotations/OI_SGG_trainval_test_categories_dict.json and
    annotations/categories_dict.json)."""
    root = Path(sgg_path)
    files = {"train": "oi_sgg_train.json", "val": "oi_sgg_test.json"}
    if image_set not in files:
        raise ValueError(f"image_set is 'train' or 'val', not {image_set!r}")
    ann = root / "annotations"
    return OISGGDataset(image_set, root / "images", ann / files[image_set],
                        ann / "OI_SGG_trainval_test_categories_dict.json", ann / "categories_dict.json",
                        num_queries, transforms, device)
