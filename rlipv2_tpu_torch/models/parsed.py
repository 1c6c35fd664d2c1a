"""RLIP-ParSeD (v2), the deformable non-DAB open-vocabulary model
(counterpart of rlipv2_tpu/models/parsed.py; reference models/hoi.py:2840-3316
and models/ParSetransformer.py:404-917).

The ALIF encoding, the vanilla_MBF verb queries and the classification
heads are RLIP-ParSeDA's; the queries and decoders differ:
  * `query_embed` (nq, 2C) splits into (query_pos, tgt), as Deformable-DETR's;
  * the `reference_points_sub` / `reference_points_obj` linear heads give
    2-d reference points (sigmoid) for the subject and object halves;
  * the plain-deformable ho and verb decoders (`models/dab_decoder.py` with
    `use_dab=False`), the verb decoder at the subject/object midpoint with
    the sum of the two halves' query positions;
  * per-layer box heads at the top, `tmp[..., :2] += inverse_sigmoid(ref)`
    (reference models/hoi.py:3080-3120).
`forward_tagger` and, with `tagger=True`, the DAB decoders it runs and
`transformer.coord_proj` come from RLIPParSeDA, as the JAX class inherits
them; the JAX model materializes those only when its init traces the
tagger, and so does this one only when built for the tagger.
`tgt_embed` and `refpoint_embed` exist and go unused, as in the JAX tree.
`verb_curing` and `masked_entity_modeling` raise ValueError: the JAX class
inherits RLIPParSeDA's heads, but its `__call__` (JAX parsed.py:66-184)
never calls them, so the options would do nothing (ROADMAP queue 3).
With `fusion_type` "no_fusion" (the factory's `rlip_parsed`, RLIP-ParSeD
v1) the encoder is the plain deformable one, its layers under DDETR's
`transformer.encoder.layers.{i}` (JAX `encoder/layers`, scanned), and the
heads read the text features resized.

Parameter names, and the JAX leaves they hold (`engine/convert.py`):
  query_embed.weight                    <- query_embed
  transformer.reference_points_{sub,obj} <- reference_points_{sub,obj}
  transformer.{ho,verb}_decoder_nd.layers.{i}
                                        <- {ho,verb}_decoder_nd/layers/layer[i]
  {sub,obj}_bbox_embed.{i}              <- {sub,obj}_bbox_embed_{i}
  transformer.{ho,verb}_decoder.*, transformer.coord_proj (tagger=True)
                                        <- {ho,verb}_decoder, coord_proj
and every other name as RLIPParSeDA has it.
"""

from __future__ import annotations

import torch
from torch import nn

from rlipv2_tpu_torch.config import ModelConfig
from rlipv2_tpu_torch.models.dab_decoder import DABHOIDecoder
from rlipv2_tpu_torch.models.layers import MLP
from rlipv2_tpu_torch.models.parseda import RLIPParSeDA
from rlipv2_tpu_torch.ops.positional import inverse_sigmoid


class RLIPParSeD(RLIPParSeDA):
    TAGGER_PREFIXES = ("transformer.coord_proj.", "transformer.ho_decoder.", "transformer.verb_decoder.")
    HEAD_PREFIXES = ()  # the JAX class never calls the curing or recon heads
    DAB = False

    def __init__(self, cfg: ModelConfig, tagger: bool = False):
        super().__init__(cfg, tagger)
        t = cfg.transformer
        d = t.hidden_dim
        tr = self.transformer
        self.query_embed = nn.Embedding(cfg.num_queries, 2 * d)
        tr.reference_points_sub = nn.Linear(d, 2)
        tr.reference_points_obj = nn.Linear(d, 2)
        tr.ho_decoder_nd = DABHOIDecoder(t, parse=True, use_dab=False)
        tr.verb_decoder_nd = DABHOIDecoder(t, parse=False, use_dab=False)

    def _box_heads(self) -> None:
        d, n = self.cfg.transformer.hidden_dim, self.cfg.transformer.dec_layers
        self.sub_bbox_embed = nn.ModuleList(MLP(d, d, 4, 3) for _ in range(n))
        self.obj_bbox_embed = nn.ModuleList(MLP(d, d, 4, 3) for _ in range(n))

    def _forward(self, pixels, pixel_valid, text_emb, text_valid, n_obj_texts, generator):
        c = self.cfg
        t = c.transformer
        tr = self.transformer
        B = pixels.shape[0]
        n_obj = c.max_obj_texts if n_obj_texts is None else n_obj_texts
        np_ = c.num_queries // 2
        d = t.hidden_dim
        enc = self._encode(pixels, pixel_valid, text_emb, text_valid, generator)
        memory = (enc["img_memory"], enc["spatial_shapes"], enc["valid_ratios"], enc["mask_flat"])

        qe = self.query_embed.weight
        query_pos = qe[None, :, :d].expand(B, c.num_queries, d)
        tgt = qe[None, :, d:].expand(B, c.num_queries, d)
        sub_ref = torch.sigmoid(tr.reference_points_sub(query_pos[:, :np_]))
        obj_ref = torch.sigmoid(tr.reference_points_obj(query_pos[:, np_:]))

        hs_ho = tr.ho_decoder_nd(tgt, sub_ref, obj_ref, *memory, query_pos=query_pos)["hs"]
        hs_h, hs_o = hs_ho[:, :, :np_], hs_ho[:, :, np_:]
        hs_verb = tr.verb_decoder_nd(self._verb_queries(hs_ho[-1]), sub_ref, obj_ref, *memory,
                                     query_pos=query_pos[:, :np_] + query_pos[:, np_:])["hs"]

        def boxes(heads, hs, ref):
            inv = inverse_sigmoid(ref)
            out = []
            for lvl, head in enumerate(heads):
                tmp = head(hs[lvl])
                out.append(torch.sigmoid(torch.cat([tmp[..., :2] + inv, tmp[..., 2:]], dim=-1)))
            return torch.stack(out)

        return self._heads(enc, hs_h, hs_o, hs_verb, boxes(self.sub_bbox_embed, hs_h, sub_ref),
                           boxes(self.obj_bbox_embed, hs_o, obj_ref), n_obj)
