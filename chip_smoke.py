"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero without printing
a result; no phase catches its own failure):
  1. device: the card's name and power limit (nvidia-smi), torch and CUDA
     versions; exits non-zero when torch sees no CUDA device;
  2. build: compiles the MSDA forward and backward kernels, the window
     attention kernel, the int8 MSDA forward kernel and the nvJPEG decoder
     of the HICO loader from the checkout's sources, one nvcc each, all
     started together;
  3. kernel vs plain: the kernel against `ms_deform_attn_plain` at the
     main path's encoder shape (832x1344: 4 levels, Q = S = 23205, B = 8,
     H = 8, D = 32), its decoder shape (Q = 200, 4-d anchors) and an
     out-of-bounds case (locations in [-0.2, 1.2]);
     float32 within 1e-5 and bfloat16 value within 2e-2 of the plain version
     computed in float32 from the same bf16 values; both timed with CUDA
     events. Every case (D = 32) must take the kernel's D = 32 gather
     design. Beside the HBM bound it prints the L2-side byte count (every
     sample's four corner rows, as the gather reads them, plus loc, attn and
     the output) and the time it takes at the L2 read rate measured here
     (a reduction over an L2-resident 16 MB buffer);
  3c. int8 MSDA vs plain: the int8 kernel (impl "pallas_int8") against
     `ms_deform_attn_int8_plain` at the shapes of phase 3 and at the
     encoder shape with init-grid locations (each token's reference point
     plus the `sampling_offset_bias_init` offsets, 1-4 level pixels along
     each head's direction, plus N(0, 0.25^2) pixel noise), float32 within
     1e-5 and bf16 value within 1e-2 of max|plain| (the same codes; one
     bf16 rounding); and against the exact `ms_deform_attn_plain` within
     2e-2 of max|exact| and not equal to it (the JAX package's bound).
     Every case must take the int8 kernel's D = 32 gather. At B = 8, the
     encoder shape and bf16, CUDA events time the kernel alone on ready
     codes at uniform and at init-grid locations, `quantize_value_int8`,
     the whole int8 path, the plain int8 version and the exact kernel;
  3b. window attention vs plain: the kernel against `window_attention_plain`
     at the four Swin-L stage shapes of the main path (832x1344, batch 8,
     window 12: N = 144, head dim 32, 6-48 heads) and at N = 49, with the
     stage's real shift mask and without; float32 within 2e-5 and bf16 qkv
     within 2e-2 of the plain version computed in float32 from the same
     bf16 values; kernel, plain and `scaled_dot_product_attention` (the
     library yardstick, on q, k, v already laid out as (nWB, h, N, d))
     timed with CUDA events at bf16 (bf16 takes the kernel's tensor-core
     tiles, float32 its SIMT design); every Swin-L stage must have the main
     path's 144 tokens a window; at the stage-3 shape the gradient through
     the kernel's autograd.Function against autograd of the plain version;
     at each bf16 shape the backward of a train step timed with CUDA events
     (through the kernel's Function, which recomputes the plain version and
     takes its autograd; the plain version's autograd alone; and
     `scaled_dot_product_attention`'s backward with the bias and mask as a
     float attn_mask) beside its bound, and the 24 calls of a micro-batch
     summed;
  4. the golden pack: the reference-layout weights and inputs of
     tests/fixtures/golden_pack.npz through the port on the card (float32,
     TF32 off), within 2e-3 of the frozen reference outputs;
  5. the main path: `tools/main_path.py::main_path_model` (preset
     rlip_parseda_v2_r50 with HICO-size text slots, 81 object and 117
     verb, 12-layer RoBERTa-base, seeded random weights), bf16 autocast, through the port's `evaluate_hoi` at batch 8
     and bucket (832, 1344) over a seeded synthetic dataset of 5 batches
     (the first is warm-up). Checks finite outputs, boxes in (0, 1), 12
     MSDA and no window-attention or int8 launches per forward, no
     backward launches and HICO stats in [0, 1]; prints img/s, p50 forward
     latency and peak device memory;
  5c. the quantized main path `eval_r50_int8`: the same through
     `tools/main_path.py::main_path_int8_model` (msda_impl "pallas_int8",
     the same seeded weights): 12 int8 MSDA launches and no exact ones per
     forward;
  5d. `eval_r50_int8_full`: `main_path_int8_model(dense=True)`, the W8A8
     projections on too: as 5c, and every int8 projection of the model
     called once per forward;
  5e. int8 fidelity, printed and not gated: the exact, int8-MSDA and
     full-int8 R50 forwards on one batch: max |delta| of the verb logits
     and boxes, the canned-GT mAP delta of `eval/int8_gate.py` against the
     exact path, its 1 % score-jitter control and the p90 relative
     verb-score error (the protocol of the JAX package's benchmark; with
     random weights the mAP is noise-bound);
  5b. the Swin-L main path: the same as 5 through
     `tools/main_path.py::main_path_swin_model` (preset
     rlip_parseda_v2_swin_l, `swin_large_384`), built after the R50 models
     are dropped; 24 window-attention and 12 MSDA launches per forward;
  6. backward kernel vs plain: dvalue, dloc and dattn of the kernel against
     autograd of `ms_deform_attn_plain` at the encoder shape with B = 2 (the
     plain oracle holds a (B, Q, H, 64, D) float32 gather and its gradient)
     at uniform and at init-grid locations, the decoder shape and the
     out-of-bounds case, every case on the D = 32 gather and vector
     scatter; float32 within 1e-4 and
     bfloat16 value and cotangent within 2e-2 of max|ref| per tensor, the
     reference computed in float32 from the same bf16 values (the reasons:
     the order of the atomic adds into dvalue changes from run to run, and
     bf16 rounds the inputs). Forward plus backward of kernel and plain are
     timed with CUDA events, and each backward alone with B = 8 at the
     encoder shape (uniform and init-grid locations) and at the decoder
     shape, held to the same 2e-2 of max|ref| per tensor against autograd
     of the plain version on its bf16 inputs, with its L2-side bytes
     (gathered bf16 corner rows, reduced float32 rows, loc, attn, grad_out,
     dloc, dattn) beside its HBM bound;
  7. the train path: `tools/main_path.py::main_train_step` (the same model
     in train mode, dropout on, backbone stem and layer1 frozen, default
     LossConfig and TrainConfig, bf16 autocast) through the port's
     `train_one_epoch` over the synthetic train split: TRAIN_STEPS steps at
     batch 8 in the (832, 1344) bucket, the first one warm-up. Checks finite
     losses and grad norms, `nonfinite` 0, 12 forward and 12 backward kernel
     launches per step, frozen parameters and FrozenBN buffers bit-identical
     and every trainable group moved; prints step p50, img/s and peak device
     memory.
  8. the fine-tune path `finetune_hico`: first each JPEG of
     tests/fixtures/hico_jpeg through nvJPEG (PSNR at least 35 dB against
     its source, which `tools/hico_fixture.py` regenerates from its seed,
     and two decodes bit-equal; ms per decode; the CMYK file must raise).
     Then, on a HICO tree written to a temporary directory
     (`tools/main_path.py::main_finetune_tree`: annotations in the
     reference schema pointing at the fixture files, a byte-level
     tokenizer learned from the label texts, and `pretrained.pth`, the main
     path's seeded weights with 100 query embeddings), the port's
     `cli.main` as scripts/finetune_hico_parseda_r50.sh runs it: preset
     rlip_parseda_v2_r50 (96 object and 160 verb slots, 12-layer
     RoBERTa-base), batch 8, RPL, pseudo verbs, 500 negative texts, the
     triplet NMS, in-graph text-encoder training, 2 loader threads, with
     `--lr_drop 1` so that the learning rate drops after the first run:
     5 steps and a checkpoint, then `--resume` for 3 steps, then `--eval
     --resume`. Checks 12 forward and 12 backward launches a step and 12
     forward launches an evaluation forward, on the D = 32 designs,
     `nonfinite` 0, all three parameter groups moved (the text encoder
     too), frozen tensors bit-identical, the resumed run's step and
     learning rates equal to the saved ones, the evaluated weights equal
     to the checkpoint's bit for bit and HICO stats in [0, 1]; prints step
     p50 (also in the 832x1344 bucket alone), img/s, peak memory, the
     loop's time between steps (its wait for the batch and the batch's copy
     to the card) and its own mean wait an epoch, and the checkpoint's size
     and save and restore seconds.
  9. the pre-training path `pretrain_mixed`: on a VG-format tree written to
     a temporary directory (`tools/main_path.py::main_pretrain_tree`: VG
     and pseudo-labelled COCO files of 200 images each over copies of the
     fixture's six JPEGs, counts drawn around VG's published means of 35
     objects and 21 relationships an image, 1200 object names and 320
     predicates drawn by a Zipf law, a tokenizer
     learned from them, and phase 8's pretrained.pth), the port's
     `cli.main` as scripts/pretrain_mixed_vgcoco_parseda_r50.sh runs it:
     preset rlip_parseda_v2_r50 at 334 + 167 text slots (what 500
     negative texts need), 12-layer RoBERTa-base trained in the graph,
     batch 8, `--iterative_paradigm 0,1` (two micro-batches, one VG and one
     COCO, accumulated into each optimizer step), the relation threshold
     0.2, the pair-overlap filter, RPL, pseudo verbs and the triplet
     filter, 2 loader threads, `--lr_drop 1`: 4 optimizer steps and a
     checkpoint, then `--resume` for 2. Checks 24 forward and 24 backward
     MSDA launches a step on the D = 32 designs, every group one VG and
     one COCO micro-batch, 334 + 167 slots in the model, every batch and
     the log lines, `nonfinite` 0, all three parameter groups moved, frozen
     tensors bit-identical, the resumed step and learning rates equal to
     the saved ones, and a triplet filter that dropped some but not all
     valid GTs; prints the optimizer-step p50, the micro-batch p50 (CUDA
     events where each micro-batch starts to encode its slot texts and
     where the optimizer starts), img/s (16 images a step), peak memory,
     the loop's time between steps, the share of GTs the filter dropped
     and the GTs a micro-batch, and the checkpoint's size and save and
     restore seconds.

  10. the Swin-L training paths through `cli.main`, the preset
     rlip_parseda_v2_swin_large (`swin_large_384`, DropPath 0.2) at full
     width, batch 8, bf16, with `--remat_encoder --ema` as the scripts pass
     them; `backbone.use_checkpoint` (no flag sets it) is given in
     `model_cfg`: off for the fine-tune, which fits without it, on for the
     pre-training, which comes within 2.5 GB of the card's 80 without it
     (SWIN_FINETUNE_CHECKPOINT, SWIN_PRETRAIN_CHECKPOINT):
     10a `finetune_swinL`, scripts/finetune_hico_swinL.sh on the HICO tree
     of phase 8's kind (`main_finetune_tree(..., "finetune_hico_swinL")`,
     RPL, in-graph RoBERTa): 4 steps and a checkpoint, --resume for 2,
     then --eval --resume of the checkpoint; 10b `pretrain_swinL`,
     scripts/pretrain_mixed_vgcocoo365_swinL.sh on a VG, COCO and O365 tree
     (`main_pretrain_tree(..., "pretrain_mixed_vgcocoo365_swinL")`, 200
     images a file, three micro-batches a step, 334 + 167 slots, the
     filters, online pseudo verbs): 2 optimizer steps and a checkpoint,
     then --resume for 1. Each checks per optimizer step 12 MSDA forward
     and 12 backward launches a micro-batch (so none in the encoder's
     recompute, which keeps the MSDA output) and 24 window-attention
     launches a micro-batch (48 with the blocks rematerialized: the
     recompute launches the kernel again), all on the main designs (a
     block that fell back to the plain version on the card would launch
     fewer), 12 and 24 an evaluation forward, the EMA on, every group
     moved (no Swin parameter frozen), the resumed step and learning rates,
     the evaluated weights against the checkpoint and HICO stats in [0, 1];
     prints step p50, img/s, peak memory, the time between steps, whether
     the blocks were rematerialized and the launches a step.
  11. the V-COCO and Open Images v6 SGG fine-tunes through `cli.main`,
     11a `finetune_vcoco` (scripts/finetune_vcoco_parseda_r50.sh) and 11b
     `finetune_oisgg` (scripts/finetune_oisgg_parseda_r50.sh), each on its
     tree over the fixture's JPEGs (`main_finetune_tree(..., script)`,
     `tools/vcoco_oisgg_tree.py`: V-COCO with COCO ids, 29 actions and
     about 20 % subject-only actions; OI with 288 object and 30 relation
     classes under made-up names, ids remapped through a larger object
     list): preset rlip_parseda_v2_r50, batch 8, bf16, 500 negative texts,
     12-layer RoBERTa-base trained in the graph, phase 8's seeded weights,
     2 loader threads, `--lr_drop 1`: 4 steps, a checkpoint and an
     evaluation of 16 val images, then `--resume` for 2 steps and another
     evaluation. Checks 12 forward and 12 backward MSDA launches a step and
     12 forward launches an evaluation forward on the D = 32 designs, no
     window or int8 launch, `nonfinite` 0, the text slots (V-COCO the
     preset's 96 + 160, OI 289 + 160), the resumed step, learning rates and
     random states, and finite evaluator stats in [0, 1]; prints step p50
     (each run's first step left out; also in the 832x1344 bucket alone),
     img/s, peak memory, the time between steps, the evaluations' wall
     seconds and the evaluator's headline stats ("mAP_all" / "mAP_thesis";
     OI's mAP, weighted mAPs and recall at top-50 and top-100 and
     `score_wtd`).

  12. RLIP-ParSeD and the R-Tagger (R50, RoBERTa-base with 12 layers,
     batch 8, bf16 autocast), through the entry points a user runs:
     12a. scripts/finetune_hico_parsed_r50.sh through `cli.main` on the
          HICO tree (`main_finetune_tree(..., "finetune_hico_parsed")`),
          as phase 11 runs its scripts: 4 steps, a checkpoint, an
          evaluation of 16 images, --resume for 2, an evaluation; every
          MSDA call of a step takes 2-d reference points (the encoder's
          and the plain-deformable decoders');
     12b. scripts/tagger_train_vg.sh through `cli.main` on the VG file of
          phase 9's tree (`main_pretrain_tree(..., "tagger_train_vg")`): 4
          steps and a checkpoint, then --resume for 2; the resumed run
          starts from the saved noise generator and pair sampler, step and
          learning rates; every `forward_tagger` attends exactly the pair
          slots its targets hold (slot 0 of an empty image), losses finite;
     12c. `python -m rlipv2_tpu_torch.tools.generate_relations` with
          scripts/tagger_generate_coco.sh's flags on 12b's checkpoint and a
          COCO tree over the JPEG fixture (`tools/coco_tree.py`): batched
          forwards of 8 rows; at threshold 0 (every score), then at those
          scores' median (random weights put none at the script's 0.2),
          which writes exactly the scores in [threshold, 1]; that output
          read back by `build_coco_rlip` for pre-training.
     12a and 12b launch the MSDA forward and backward kernels 12 times a
     step, and every forward 12 forward launches, on their D = 32 designs,
     no window or int8 launch; each prints its step (12c: its forward)
     p50, img/s (12c: rows/s), peak memory, the time between steps, its
     wall time and its launch counts.

  13. the RLIPv1 family (R50 widths: hidden 256, 6 encoder and 3 decoder
     layers, 200 queries, RoBERTa-base with 12 layers, batch 8, bf16):
     13a-c. `finetune_hico_rlip_parsed`, `_rlip_parse`, `_rlip_parse_v2`:
          scripts/finetune_hico_parsed_r50.sh's command with --variant
          rlip_parsed | rlip_parse | rlip_parse_v2 through `cli.main` on the
          HICO tree (`main_finetune_tree(..., script)`), as phase 11 runs its
          scripts: 4 steps, a checkpoint, an evaluation of 16 images,
          --resume for 2, an evaluation. RLIP-ParSeD v1 (the plain
          deformable encoder) launches the MSDA forward and backward
          kernels 12 times a step and the forward 12 times an evaluation
          forward, on 2-d reference points and the D = 32 designs; the
          dense RLIP-ParSe and RLIP-ParSe v2 launch no MSDA, window or
          int8 kernel. The last step runs under torch.profiler: its busy
          share. Each prints step p50, peak memory and the busy share;
     13d. batched inference, as phase 5, of RLIP-ParSeD v1, RLIP-ParSe,
          RLIP-ParSe v2 and RLIPParSeV1Joint
          (`tools/main_path.py::main_path_rlipv1_model`; V1Joint reads
          pooled label features of a seeded RoBERTa-base,
          `pooled_text_encoder`): 12 MSDA launches a forward for
          RLIP-ParSeD v1, none for the others; p50 latency and img/s.

  14. RLIP-ParSeDA's loss and head options through `cli.main`, on phase 8's
     HICO tree and pretrained.pth (without the curing and recon heads,
     which keep their seeded values), at the R50 preset's full width
     (hidden 256, 6 encoder and 3 decoder layers, 200 queries), batch 8,
     bf16:
     14a. `finetune_hico_heads`, scripts/finetune_hico_parseda_r50.sh's
          command with --verb_curing --masked_entity_modeling
          --exponential_loss --obj_loss_type focal --verb_loss_type
          asymmetric_bce: 4 steps, a checkpoint and an evaluation,
          --resume for 2 and an evaluation, then --eval --eval_uniformity
          of the checkpoint (stats, uniformity, alignment, n_features, the
          npz's size);
     14b. `finetune_hico_matching`, the same with cross_modal_matching
          object and verb losses: 4 steps and an evaluation; the curing
          heads take no gradient (the curing score is outside the loss's
          graph), where in 14a its gradient is read every step and printed
          (with RPL on seeded weights the asymmetric BCE's margin leaves it
          zero);
     both launch the MSDA forward and backward kernels 12 + 12 times a step
     and 12 an evaluation forward on the D = 32 designs, every evaluation
     forward returns the curing score that the evaluation multiplies in,
     each run's last step is profiled (device time and busy share); each
     prints step p50 against phase 8's, peak memory and launches;
     14c. the criterion on the card against the CPU in float32 on the first
          14a batch's outputs (CRITERION_CASES: every verb loss type, the
          three object loss types, with the curing, recon and exponential
          terms, with RPL and, for the four BCE forms, without it, so that
          they see positives and the curing score takes a gradient), both on
          the CPU's matching: the largest relative difference of the loss
          terms and of the gradients with respect to the outputs (each
          against its own largest |grad|, or the case's largest where its
          own is zero), within CRITERION_REL_TOL.

  15. the closed-vocabulary zoo (`models/closed_vocab.py`; the 13 variants
     of ZOO_MSDA_PER_FORWARD) at the R50 preset's full width
     (`tools/main_path.py::main_path_zoo_model`: hidden 256, 6 encoder
     and 3 decoder layers, 200 queries, ResNet-50, 96 object and 160 verb
     head columns, seeded weights), batch 8 at 832x1344, bf16 autocast:
     15a. batched inference: ZOO_FORWARDS forwards of each variant, the
          first warm-up; the four MSDA members through `evaluate_hoi` on
          the synthetic val split with an apply_fn that passes no text and
          hands the evaluator the split's columns
          (`closed_vocab.evaluation_columns`), the others on its first
          batch. Every forward must launch the MSDA forward kernel
          ZOO_MSDA_PER_FORWARD times (QAHOI and its two-stage form 6 + 3,
          SepDDETRHOIv3 and ParSe-DAB-DDETR 6 + 3 + 3, the dense members
          none) on the D = 32 design, and nothing else; finite outputs,
          boxes in (0, 1); each prints p50 latency, img/s and peak memory;
     15b. one backward of SetCriterionHOI's weighted total on seeded
          targets (DETRHOIhm's plus `loss_verb_hm` against a heatmap of
          `data/heatmap.py`) in train mode, for ZOO_BACKWARD: the MSDA
          backward launches must equal the forward's, every gradient is
          finite, and the OCN and Coupled prior buffers take none;
     15c. the criterion on the card against the CPU, float32, on the
          first 15a output of QAHOI and of DETRHOIhm (with
          `loss_verb_hm`), both on the CPU's matching: the largest
          relative difference of the loss terms and of the gradients with
          respect to the outputs, within CRITERION_REL_TOL.
 16. the last factory variants, the detector warm starts and the COCO
     detector at the R50 preset's widths, batch 8 at 832x1344, bf16, on
     the synthetic val split's first batch:
     16a. ParSe-DAB-DETR (`main_path_zoo_model`) and RLIP-MDETR
          (`main_path_rlipv1_model`, label features from a seeded
          RoBERTa-base): DENSE_FORWARDS forwards each, the first warm-up,
          no kernel launch, finite outputs, boxes in (0, 1); p50, img/s
          and peak memory;
     16b. for DAB-Deformable-DETR, Deformable-DETR and DETR, a seeded
          full-width detector state dict in that reference key space
          (`detector_state_dict`), written as a `.pth` and read back,
          converted and loaded over RLIP-ParSeDA, RLIP-ParSeD and
          RLIP-ParSe v1 (`main_path_warm_start_model`): every converted
          tensor bit-equal in the model on the card, the keys left at init
          counted; WARM_FORWARDS forwards each, the MSDA forward 12, 12
          and 0 times a forward on the D = 32 design;
     16c. `DETRDetector` with 91 classes (`main_path_detector_model`):
          DETECTOR_FORWARDS forwards (no kernel launch); DETECTOR_STEPS
          forwards and backwards of `detection_losses` on seeded targets
          (the first cold), finite gradients, step ms and peak memory; `postprocess_detection` and
          `coco_evaluate` over a seeded COCO GT json of the 8 images, wall
          seconds and the AP summary (printed, not checked: random
          weights).
 17. data-parallel training and the sharded HICO-DET evaluation through
     torchrun (`python -m torch.distributed.run --standalone`; each rank
     is this script with `--phase17-rank DIR -- <flags>`, which runs
     `cli.main` with its launches counted and writes its numbers to DIR),
     scripts/finetune_hico_parseda_r50.sh's command on phase 8's tree
     parts with a val split of landscape files (`main_finetune_tree(...,
     val_landscape=True)`: every evaluation batch pads to 832x1344,
     whichever images it holds), RLIP-ParSeDA R50 at full width, bf16, a
     global batch of 8, two loader threads, every dropout off in every
     run (each rank draws its own masks, so only runs without them compare
     number for number):
     17a. `--nproc_per_node 2 --dist_backend gloo`, both ranks on the one
          card, 4 images a rank: DP_STEPS steps, a checkpoint and the
          sharded evaluation of DP_VAL_IMAGES images (not a multiple of 2
          ranks x 4, so the shards wrap). Gates: the first step's loss and
          grad norm within DP_REL_TOL of a one-process run of the same
          command (run first, in this process); on each rank 12 MSDA
          forward and 12 backward launches a step and 12 an evaluation
          forward, on the D = 32 designs; every val image once after the
          dedupe, in image order, on both ranks, the ranks' shards
          covering them; each image's top verb score within DP_REL_TOL of
          the largest of a one-process evaluation of the checkpoint 17a
          wrote (run after, in this process); both ranks the same stats;
          the checkpoint and log.txt written by rank 0 alone. Prints each
          rank's step times (two ranks sharing one card over gloo: not a
          multi-GPU figure) and peak memory;
     17b. `--nproc_per_node 1` under nccl: one step and the evaluation,
          its gather through NCCL on CUDA tensors (13 images wrap-padded to
          16): the same launch and coverage gates.

Phase 5e also prints, once, the spread of the main path's sampling
offsets: the p50 and p90 of |offset| in level pixels of the first encoder
layer in one eval_r50 forward, read by a forward hook.

Phases 8, 11, 12a, 13a-c and 17 share their parts of the fine-tune trees
(`main_finetune_tree(..., shared=...)`): a HICO tree of the same split
sizes, a dataset's tokenizer, the pretrained.pth of a preset and variant
are written once. The script prints each phase's seconds and the total so
far (`[elapsed]`).

Before the main path of phases 5, 5c, 5d, 5b, 7, 8, 9, 10a, 10b, 11a, 11b,
12a-12c, 13a-13d, 14a, 14b, 15a, 15b, 16a-16c, 17a and 17b (in each rank) every launch count is set to 0, and each is read just
after; every MSDA forward launch there must have taken the D = 32 gather,
every backward launch the D = 32 gather and vector scatter, every int8
launch the D = 32 int8 gather, and every window-attention launch must have had bf16 qkv with N = 144 (the
tensor-core tiles). The kernel phases print the redesigned kernels'
earlier per-call times as a line of its own, quoted from PERF.md and not
measured in the run. The line before the last
two is the card's name and power limit, the second-to-last a JSON object
{"kernels": [...]} with each kernel's launches (in all, and by path), error
against its plain version, times, bound and library time, and the last
line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import functools
import gc
import importlib
import json
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ENC_SHAPES = ((104, 168), (52, 84), (26, 42), (13, 21))  # 832x1344 at strides 8-64
N_BATCHES = 5
MSDA_PER_FORWARD = 12  # 6 encoder + 3 ho-decoder + 3 verb-decoder layers
WINDOW_PER_FORWARD = 24  # Swin-L blocks: 2 + 2 + 18 + 2
TRAIN_STEPS = 6
# phase 8: steps of the first run and of the resumed one, and the HICO
# tree's split sizes (five batches of 8 train images; two of val)
FINETUNE_STEPS = (5, 3)
FINETUNE_TRAIN_IMAGES, FINETUNE_VAL_IMAGES = 40, 16
# phase 9: optimizer steps of the first run and of the resumed one; the
# micro-batches a step accumulates (--iterative_paradigm 0,1) and the text
# slots that --negative_text_sampling 500 needs
PRETRAIN_STEPS = (4, 2)
PRETRAIN_MICRO = 2
PRETRAIN_SLOTS = (334, 167)
# phase 10: the Swin-L fine-tune's steps of the first run and of the
# resumed one and its HICO tree's split sizes; the Swin-L pre-training's
# optimizer steps and micro-batches a step (--iterative_paradigm 0,1,2).
# Whether each rematerializes the Swin blocks (`backbone.use_checkpoint`):
# without it the fine-tune peaked at 53.6 GB in the 832 x 1344 and 1088^2
# buckets (`tools/profile_finetune.py`) and at 70.9-73.9 GB with a batch in the
# largest, 1344^2 (this phase), and the pre-training, whose groups mostly
# pad to 1344^2, at 77.6 GB of the card's 80 (32.7 with it; PERF.md section 6),
# so the fine-tune runs without it and the pre-training with it
SWIN_FINETUNE_STEPS = (4, 2)
SWIN_FINETUNE_TRAIN_IMAGES, SWIN_FINETUNE_VAL_IMAGES = 48, 16
SWIN_FINETUNE_CHECKPOINT = False
SWIN_PRETRAIN_STEPS = (2, 1)
SWIN_PRETRAIN_MICRO = 3
SWIN_PRETRAIN_CHECKPOINT = True
# phase 11: the V-COCO and Open Images v6 SGG fine-tunes (R50): steps of the
# first run and of the resumed one, and each tree's split sizes; the text
# slots each must run at (OI-SGG's 288 objects take 289 object slots at 500
# negative texts, V-COCO keeps the preset's)
DOWNSTREAM_STEPS = (4, 2)
DOWNSTREAM_TRAIN_IMAGES, DOWNSTREAM_VAL_IMAGES = 32, 16
DOWNSTREAM_SCRIPTS = {  # tag: (tools/main_path.py script, evaluation, text slots, headline stats)
    "finetune_vcoco": ("finetune_vcoco", "evaluate_vcoco", (96, 160), ("mAP_all", "mAP_thesis")),
    "finetune_oisgg": ("finetune_oisgg", "evaluate_sgg", (289, 160), (
        "mAP@50 (RelD)", "wmAP@50 (RelD)", "max recall@50 (RelD)", "mAP@100 (RelD)", "wmAP@100 (RelD)",
        "wmAP@100 (PhrD)", "max recall@100 (RelD)", "score_wtd (mAP)", "score_wtd (wmAP)")),
}
# phase 12a: RLIP-ParSeD's HICO-DET fine-tune, run as phase 11 runs its scripts
PARSED_SCRIPTS = {
    "finetune_hico_parsed": ("finetune_hico_parsed", "evaluate_hoi", (96, 160),
                             ("mAP", "mAP rare", "mAP non-rare", "mean max recall")),
}
# phase 12b: the R-Tagger's steps in the first run and in the resumed one;
# 12c: the COCO tree's images, the script's relation threshold and the rows
# a batched forward takes (generate_relations' batch)
TAGGER_STEPS = (4, 2)
COCO_IMAGES, TAGGER_THRESHOLD, TAGGER_ROWS = 48, 0.2, 8
# phase 13a-c: the RLIPv1 family's HICO-DET fine-tunes (finetune_hico_parsed's
# command with --variant), run as phase 11 runs its scripts: tag: (tools/main_path.py
# script, evaluation, text slots, headline stats)
RLIPV1_SCRIPTS = {
    f"finetune_hico_{v}": (f"finetune_hico_{v}", "evaluate_hoi", (96, 160),
                           ("mAP", "mAP rare", "mAP non-rare", "mean max recall"))
    for v in ("rlip_parsed", "rlip_parse", "rlip_parse_v2")
}
# 13d: batched inference of the family: tag: (variant, MSDA forward launches a forward)
RLIPV1_EVALS = {"eval_rlip_parsed": ("rlip_parsed", MSDA_PER_FORWARD), "eval_rlip_parse": ("rlip_parse", 0),
                "eval_rlip_parse_v2": ("rlip_parse_v2", 0), "eval_rlip_parse_v1_joint": ("rlip_parse_v1_joint", 0)}
# the last dim of the reference points of each model class's MSDA calls a
# step (RLIP-ParSeD's decoders take 2-d points as the encoder does,
# RLIP-ParSeDA's 4-d anchors; the dense ParSe models none)
REFERENCE_DIMS = {"RLIPParSeDA": {2: MSDA_PER_FORWARD // 2, 4: MSDA_PER_FORWARD // 2},
                  "RLIPParSeD": {2: MSDA_PER_FORWARD}, "RLIPParSe": {}, "RLIPParSeV2": {}}
# phase 14: RLIP-ParSeDA's loss and head options on phase 8's HICO tree: tag
# (tools/main_path.py script): steps of the first run and of the resumed one
# (none: no resume), and whether --eval --eval_uniformity follows
HEADS_SCRIPTS = {"finetune_hico_heads": ((4, 2), True), "finetune_hico_matching": ((4, 0), False)}
# 14c: the criterion on the card against the CPU, float32, on one 14a batch's
# outputs: (verb_loss_type, obj_loss_type, RPL), every verb type with the
# object CE and the other object types, all with the curing and recon terms,
# pseudo verbs and the exponential aux decay, with RPL; the four BCE forms
# also without RPL, where they see positives (with RPL they count none).
# The largest relative difference of any loss term and of any output's
# gradient (against its largest |grad|, or the case's largest over every
# output where its own is zero) that passes. Float32 rounding in another
# order of summation gives ~1e-6; a wrong term or gradient gives far more
BCE_FORMS = ("bce", "weighted_bce", "asymmetric_bce", "CB_focal_bce")
CRITERION_CASES = (*((v, "cross_entropy", True) for v in ("focal", *BCE_FORMS, "cross_modal_matching")),
                   ("focal", "focal", True), ("focal", "cross_modal_matching", True),
                   *((v, "cross_entropy", False) for v in BCE_FORMS))
CRITERION_REL_TOL = 1e-4
# phase 15: the closed-vocabulary zoo: variant -> MSDA forward launches a
# forward (the deformable encoder's 6 layers, then 3 per deformable decoder;
# the dense DETR members none)
ZOO_MSDA_PER_FORWARD = {"qpic": 0, "cdn": 0, "qahoi": 6 + 3, "ocn": 0, "sep_detr_hoi": 0,
                        "sep_ddetr_hoi_v3": 6 + 3 + 3, "seq_detr_hoi": 0, "stochastic_detr_hoi": 0,
                        "iterative_detr_hoi": 0, "detr_hoi_hm": 0, "coupled_detr_hoi": 0, "qahoi_two_stage": 6 + 3,
                        "parse_dab_ddetr": 6 + 3 + 3}
# 15a: the forwards of each variant, the first warm-up (the MSDA members':
# the batches of the synthetic val split through evaluate_hoi)
ZOO_FORWARDS = 4
# 15b: the variants that take one backward (the MSDA members, DETRHOIhm and
# the two with prior buffers); 15c: those whose first 15a output the
# criterion takes on the card and on the CPU; the GT pair slots an image
ZOO_BACKWARD = ("qahoi", "qahoi_two_stage", "sep_ddetr_hoi_v3", "parse_dab_ddetr", "detr_hoi_hm", "ocn",
                "coupled_detr_hoi")
ZOO_CRITERION = ("qahoi", "detr_hoi_hm")
ZOO_EVALUATE = tuple(v for v, n in ZOO_MSDA_PER_FORWARD.items() if n)  # 15a through evaluate_hoi
ZOO_TARGETS = 8
ZOO_PRIORS = ("verb_word_embedding", "obj_verb_co")
# phase 16a: the last two factory variants, dense (no kernel launch): tag:
# (tools/main_path.py builder, variant); the forwards of each, the first warm-up
DENSE_VARIANTS = {"eval_parse_dab_detr": ("main_path_zoo_model", "parse_dab_detr"),
                  "eval_rlip_mdetr": ("main_path_rlipv1_model", "rlip_mdetr")}
DENSE_FORWARDS = 11
# 16b: detector warm starts: tag: (the HOI variant, the detector's reference
# key space, MSDA forward launches a forward of the warm-started model); the
# detectors' query counts (DAB-/Deformable-DETR 300, DETR 100, fitted by the
# converters to the preset's 200); the forwards, the first warm-up
WARM_STARTS = {"warm_rlip_parseda": ("rlip_parseda_v2", "dab_ddetr", MSDA_PER_FORWARD),
               "warm_rlip_parsed": ("rlip_parsed_v2", "ddetr", MSDA_PER_FORWARD),
               "warm_rlip_parse_v1": ("rlip_parse_v1_joint", "detr", 0)}
DETECTOR_QUERIES = {"dab_ddetr": 300, "ddetr": 300, "detr": 100}
WARM_FORWARDS = 4
# 16c: the COCO detector's classes, its forwards (the first warm-up), its
# forwards and backwards of the loss (the first a process's first) and the
# seeded GT boxes an image of its loss and COCO evaluation
DETECTOR_CLASSES = 91
DETECTOR_FORWARDS = 11
DETECTOR_STEPS = 3
DETECTOR_TARGETS = 8
# phase 17: 17a's steps; the tree's split sizes (DP_STEPS batches of 8; val
# images not a multiple of 2 ranks x 4); the relative tolerance of the bf16
# runs against one process (PERF.md section 2's bf16 gate); each torchrun
# call's time limit
DP_STEPS = 3
DP_TRAIN_IMAGES, DP_VAL_IMAGES = 24, 13
DP_REL_TOL = 2e-2
DP_TIMEOUT_S = 420
KERNELS = {  # name: (source, the TPU kernel it replaces)
    "ms_deform_attn_fwd": ("rlipv2_tpu_torch/ops/csrc/ms_deform_attn_fwd.cu",
                           "rlipv2_tpu/ops/ms_deform_attn_v4.py:87"),
    "ms_deform_attn_bwd": ("rlipv2_tpu_torch/ops/csrc/ms_deform_attn_bwd.cu",
                           "rlipv2_tpu/ops/ms_deform_attn_v4.py:267"),
    "window_attention_fwd": ("rlipv2_tpu_torch/ops/csrc/window_attention_fwd.cu",
                             "rlipv2_tpu/ops/window_attention.py:56"),
    "ms_deform_attn_int8_fwd": ("rlipv2_tpu_torch/ops/csrc/ms_deform_attn_int8_fwd.cu",
                                "rlipv2_tpu/ops/ms_deform_attn_v4.py:843"),
}
# built with the kernels: the nvJPEG decoder of the HICO loader (no kernel
# of its own, so not on the kernels line)
BUILT_BESIDE = ("jpeg_decode.cu",)
# NVIDIA H100 SXM data sheet at 700 W: HBM bandwidth; the float32 rate
# outside the tensor cores (the MSDA kernels do scalar float32 arithmetic);
# the dense bf16 tensor-core rate (window attention's work is two matrix
# products a window and head)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
PEAK_BF16_TENSOR_OPS_PER_S = 989e12
RATE_NAMES = {PEAK_F32_OPS_PER_S: "float32 non-tensor 67 TFLOP/s",
              PEAK_BF16_TENSOR_OPS_PER_S: "bf16 tensor core 989 TFLOP/s"}
# the MSDA backward's bound on each of dvalue, dloc and dattn in bf16, as a
# share of that gradient's max|ref| (autograd of the plain version)
BWD_BF16_REL_TOL = 2e-2
# the MSDA designs the main paths must take (the wrapper counts launches by
# design: forward, backward, int8); window attention's design follows qkv's
# dtype, and the main paths must launch it on bf16 windows of 144 tokens
MSDA_MAIN_DESIGN = "gather_d32"
MSDA_BWD_MAIN_DESIGN = "gather_scatter_d32"
MSDA_INT8_MAIN_DESIGN = "gather_d32"
WINDOW_MAIN_LAUNCH = "bfloat16/N144"
# the per-call times of the designs that the redesigned kernels replaced, at
# the shapes of their kernels-line rows (MSDA: the encoder shape, B 8, bf16,
# uniform locations; window attention: Swin-L stage 0 with the shift mask,
# bf16), quoted from PERF.md section 6 (NVIDIA H100 80GB HBM3, 700 W).
# Those designs no longer run on the main paths, so this run does not
# measure them and prints them apart from the kernels line
QUOTED_EARLIER_MS = {"ms_deform_attn_fwd": 3.888, "window_attention_fwd": 7.098,
                     "ms_deform_attn_bwd": 8.715, "ms_deform_attn_int8_fwd": 4.838}


def log(msg: str) -> None:
    print(msg, flush=True)


def device_phase() -> str:
    from rlipv2_tpu_torch.tools.main_path import gpu_name_and_power_limit

    smi = gpu_name_and_power_limit()
    log(f"[device] {smi}")
    log(f"[device] python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    if not torch.cuda.is_available():
        raise SystemExit("torch sees no CUDA device")
    return smi


def build_phase() -> None:
    from rlipv2_tpu_torch.ops.cuda_build import build

    t0 = time.perf_counter()
    sources = [src.rsplit("/", 1)[1] for src, _ in KERNELS.values()] + list(BUILT_BESIDE)
    with ThreadPoolExecutor(len(sources)) as pool:
        libs = list(pool.map(lambda src: build(src, verbose=True), sources))
    log(f"[build] {', '.join(lib.name for lib in libs)} in {time.perf_counter() - t0:.2f} s")


def _cuda_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _msda_inputs(shapes, B, Q, H, D, P, lo, hi, gen, dev):
    L = len(shapes)
    S = sum(h * w for h, w in shapes)
    value = torch.randn(B, S, H, D, generator=gen, device=dev)
    loc = lo + (hi - lo) * torch.rand(B, Q, H, L, P, 2, generator=gen, device=dev)
    attn = torch.softmax(torch.randn(B, Q, H, L * P, generator=gen, device=dev), -1)
    return value, loc, attn.view(B, Q, H, L, P)


def _case_locations(name, loc, B, Q, gen):
    """The case's locations: decoder anchors, the encoder's init grid (each
    token's reference point plus the sampling-offset init plus N(0, 0.25^2)
    pixel noise), both from `tools/msda_locations.py`, or the uniform draw
    `loc` of `_msda_inputs`."""
    from rlipv2_tpu_torch.tools.msda_locations import decoder_locations, encoder_locations

    if name.startswith("decoder"):
        return decoder_locations(B, Q, 8, len(ENC_SHAPES), 4, gen)
    if name.endswith("init_grid"):
        return encoder_locations("init_grid", ENC_SHAPES, B, 8, 4, gen, Q=Q)
    return loc


def _valid_corners(shapes, loc) -> int:
    """Bilinear corners inside their level: the samples this data needs."""
    n = 0
    for lvl, (h, w) in enumerate(shapes):
        x0 = torch.floor(loc[..., lvl, :, 0] * w - 0.5)
        y0 = torch.floor(loc[..., lvl, :, 1] * h - 0.5)
        vx = [(x0 + i >= 0) & (x0 + i <= w - 1) for i in (0, 1)]
        vy = [(y0 + i >= 0) & (y0 + i <= h - 1) for i in (0, 1)]
        n += sum(int((a & b).sum()) for a in vx for b in vy)
    return n


def _bound(n_bytes: int, n_ops: int, ops_per_s: float = PEAK_F32_OPS_PER_S) -> dict:
    """Least time on the card: bytes over HBM bandwidth or operations over
    `ops_per_s` (by default the float32 non-tensor-core rate), whichever is
    larger."""
    by_bytes = 1e3 * n_bytes / PEAK_BYTES_PER_S
    by_ops = 1e3 * n_ops / ops_per_s
    return {"bound_ms": max(by_bytes, by_ops), "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bound_bytes": n_bytes, "bound_ops": n_ops, "bound_rate": RATE_NAMES[ops_per_s]}


def _design_delta(counter: dict, before: dict) -> dict:
    return {k: v - before[k] for k, v in counter.items() if v != before[k]}


def l2_read_rate() -> float:
    """Bytes/s at which a float32 row sum reads a 16 MB buffer that stays in
    the 50 MB L2, 64 times in one launch (a stride-0 view): the L2 read rate
    a PyTorch reduction reaches here (L1 hits, if any, count in it)."""
    x = torch.ones(4 << 20, device="cuda")
    rows = x.expand(64, -1)
    ms = _cuda_ms(lambda: rows.sum(dim=1), 50)
    rate = rows.numel() * 4 / (ms * 1e-3)
    log(f"[kernel] L2 read rate: {rate / 1e12:.3f} TB/s (64 row sums over one 16 MB L2-resident buffer, "
        f"{ms:.5f} ms)")
    return rate


def kernel_phase(l2_rate: float) -> list[dict]:
    from rlipv2_tpu_torch.ops.ms_deform_attn import ms_deform_attn, ms_deform_attn_plain
    from rlipv2_tpu_torch.tools.main_path import BATCH

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    S = sum(h * w for h, w in ENC_SHAPES)
    cases = [
        ("encoder", dict(B=BATCH, Q=S, lo=0.0, hi=1.0)),
        ("decoder_q200", dict(B=BATCH, Q=200, lo=0.0, hi=1.0)),
        ("out_of_bounds", dict(B=2, Q=4096, lo=-0.2, hi=1.2)),
    ]
    results = []
    for name, c in cases:
        value, loc, attn = _msda_inputs(ENC_SHAPES, c["B"], c["Q"], 8, 32, 4, c["lo"], c["hi"], gen, dev)
        loc = _case_locations(name, loc, c["B"], c["Q"], gen)
        for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
            v = value.to(dtype)
            before = dict(ms_deform_attn.designs)
            got = ms_deform_attn(v, ENC_SHAPES, loc, attn)
            designs = _design_delta(ms_deform_attn.designs, before)
            if designs != {MSDA_MAIN_DESIGN: 1}:
                raise AssertionError(f"{name} at D = 32 took the designs {designs}, not {MSDA_MAIN_DESIGN}")
            want = ms_deform_attn_plain(v.float(), ENC_SHAPES, loc, attn)
            torch.cuda.synchronize()
            err = float((got.float() - want).abs().max())
            iters = 20 if c["Q"] > 1000 else 200
            ms = _cuda_ms(lambda: ms_deform_attn(v, ENC_SHAPES, loc, attn), iters)
            plain_ms = _cuda_ms(lambda: ms_deform_attn_plain(v, ENC_SHAPES, loc, attn), iters)
            row = {"case": f"{name}/{str(dtype).replace('torch.', '')}", "Q": c["Q"], "B": c["B"],
                   "max_abs_err": err, "tol": tol, "ms": ms, "plain_ms": plain_ms,
                   # each input read once, the output written once; 2 operations
                   # (multiply, add) per valid corner and channel
                   **_bound(sum(t.numel() * t.element_size() for t in (v, loc, attn, got)),
                            2 * 32 * _valid_corners(ENC_SHAPES, loc))}
            # the L2 side: four corner rows of D values for every sample, as
            # the gather reads them (an invalid corner reads a clamped row),
            # plus loc, attn and the output once
            row["design"] = MSDA_MAIN_DESIGN
            row["l2_bytes"] = (attn.numel() * 4 * 32 * v.element_size()
                               + sum(t.numel() * t.element_size() for t in (loc, attn, got)))
            row["l2_read_rate"] = l2_rate
            row["l2_ms"] = 1e3 * row["l2_bytes"] / l2_rate
            log(f"[kernel] {json.dumps(row)}")
            if not err <= tol:
                raise AssertionError(f"kernel disagrees with plain version: {row}")
            results.append(row)
    return results


def int8_kernel_phase(l2_rate: float) -> tuple[list[dict], dict]:
    """The int8 MSDA kernel against `ms_deform_attn_int8_plain` (the same
    codes) and against the exact `ms_deform_attn_plain` (fidelity), at the
    shapes of phase 3 and at the encoder shape with init-grid locations;
    every launch must take the D = 32 gather. Returns the case rows and the
    timing row: at B = 8, the encoder shape and bf16, the kernel alone on
    ready codes at uniform and at init-grid locations, the quantize pass,
    the whole int8 path, its plain version and the exact kernel."""
    from rlipv2_tpu_torch.ops.ms_deform_attn import (
        launch_int8_kernel, ms_deform_attn, ms_deform_attn_int8_plain, ms_deform_attn_plain,
        quantize_value_int8)
    from rlipv2_tpu_torch.tools.main_path import BATCH

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    S = sum(h * w for h, w in ENC_SHAPES)
    cases = [
        ("encoder", dict(B=BATCH, Q=S, lo=0.0, hi=1.0)),
        ("encoder_init_grid", dict(B=BATCH, Q=S, lo=0.0, hi=1.0)),
        ("decoder_q200", dict(B=BATCH, Q=200, lo=0.0, hi=1.0)),
        ("out_of_bounds", dict(B=2, Q=4096, lo=-0.2, hi=1.2)),
    ]
    rows, timing = [], {}
    for name, c in cases:
        value, loc, attn = _msda_inputs(ENC_SHAPES, c["B"], c["Q"], 8, 32, 4, c["lo"], c["hi"], gen, dev)
        loc = _case_locations(name, loc, c["B"], c["Q"], gen)
        # float32 within 1e-5 of max|plain| (the same codes, sums in another
        # order); bf16 within 1e-2 (one bf16 rounding of the float32 sum)
        for dtype, rel in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
            v = value.to(dtype)
            before = dict(ms_deform_attn.int8_designs)
            with torch.no_grad():
                got = ms_deform_attn(v, ENC_SHAPES, loc, attn, impl="pallas_int8").float()
                want = ms_deform_attn_int8_plain(v, ENC_SHAPES, loc, attn).float()
                exact = ms_deform_attn_plain(v.float(), ENC_SHAPES, loc, attn)
            designs = _design_delta(ms_deform_attn.int8_designs, before)
            if designs != {MSDA_INT8_MAIN_DESIGN: 1}:
                raise AssertionError(f"int8 {name} at D = 32 took the designs {designs}")
            torch.cuda.synchronize()
            scale, exact_scale = float(want.abs().max()), float(exact.abs().max())
            row = {"case": f"{name}/{str(dtype).replace('torch.', '')}", "Q": c["Q"], "B": c["B"],
                   "design": MSDA_INT8_MAIN_DESIGN,
                   "max_abs_err": float((got - want).abs().max()), "max_abs_plain": scale, "rel_tol": rel,
                   # fidelity: the JAX package's bound on the int8 path
                   "max_abs_err_vs_exact": float((got - exact).abs().max()), "max_abs_exact": exact_scale}
            log(f"[int8] {json.dumps(row)}")
            if not row["max_abs_err"] <= rel * scale:
                raise AssertionError(f"int8 kernel disagrees with its plain version: {row}")
            if not 0.0 < row["max_abs_err_vs_exact"] <= 2e-2 * exact_scale:
                raise AssertionError(f"int8 kernel outside 2e-2 of the exact function, or equal to it: {row}")
            rows.append(row)
            del got, want, exact
            if name.startswith("encoder") and dtype == torch.bfloat16:
                q8, scales = quantize_value_int8(v, ENC_SHAPES)
                out = launch_int8_kernel(q8, scales, ENC_SHAPES, loc, attn, dtype)
                iters = 20
                with torch.no_grad():
                    t = {"case": row["case"], "B": c["B"], "Q": c["Q"], "max_abs_err": row["max_abs_err"],
                         "ms": _cuda_ms(lambda: launch_int8_kernel(q8, scales, ENC_SHAPES, loc, attn, dtype), iters)}
                    if name == "encoder":
                        t.update({
                            "quantize_ms": _cuda_ms(lambda: quantize_value_int8(v, ENC_SHAPES), iters),
                            "int8_path_ms": _cuda_ms(
                                lambda: ms_deform_attn(v, ENC_SHAPES, loc, attn, impl="pallas_int8"), iters),
                            "plain_ms": _cuda_ms(lambda: ms_deform_attn_int8_plain(v, ENC_SHAPES, loc, attn), 3),
                            "exact_kernel_ms": _cuda_ms(lambda: ms_deform_attn(v, ENC_SHAPES, loc, attn), iters),
                        })
                # the kernel: the int8 codes, the scales, loc and attn read once,
                # the output written once; 2 operations (the integer multiply and
                # add) per valid corner and channel
                t.update(_bound(sum(x.numel() * x.element_size() for x in (q8, scales, loc, attn, out)),
                                2 * 32 * _valid_corners(ENC_SHAPES, loc)))
                # the L2 side: four 32-byte int8 corner rows for every sample, as
                # the gather reads them, plus loc, attn, the scales and the output
                t["l2_bytes"] = attn.numel() * 4 * 32 + sum(
                    x.numel() * x.element_size() for x in (loc, attn, scales, out))
                t["l2_read_rate"] = l2_rate
                t["l2_ms"] = 1e3 * t["l2_bytes"] / l2_rate
                if name == "encoder":
                    # the quantize pass: the value read once, codes and scales
                    # written once; its time adds to the kernel's on the main path
                    qb = _bound(sum(x.numel() * x.element_size() for x in (v, q8, scales)), 0)
                    t["quantize_bound_ms"], t["quantize_bound_bytes"] = qb["bound_ms"], qb["bound_bytes"]
                log(f"[int8] timing: {json.dumps(t)}")
                timing[name] = t
                del q8, scales, out
        del value, loc, attn, v
        torch.cuda.empty_cache()
    return rows, timing


def _swin_stage_grids(spec, bucket, batch) -> list[tuple[int, int, int]]:
    """(Hp, Wp, nWB) of each stage of a Swin backbone at `bucket`, padded
    as the backbone pads: patch grid ceil(side / 4), padded to window
    multiples at each stage, halved (rounding up) by each PatchMerging."""
    ws = spec.window_size
    H, W = -(-bucket[0] // 4), -(-bucket[1] // 4)
    grids = []
    for _ in spec.depths:
        Hp, Wp = H + (-H) % ws, W + (-W) % ws
        grids.append((Hp, Wp, batch * (Hp // ws) * (Wp // ws)))
        H, W = -(-H // 2), -(-W // 2)
    return grids


def window_phase() -> tuple[list[dict], dict, dict]:
    """The window-attention kernel against `window_attention_plain` at the
    Swin-L stage shapes of the main path and at N = 49. Returns the case
    rows, the per-forward totals at bf16, and the gradient check."""
    import torch.nn.functional as F

    from rlipv2_tpu_torch.models.swin import SWIN_SPECS, shifted_window_mask
    from rlipv2_tpu_torch.ops.window_attention import window_attention, window_attention_plain
    from rlipv2_tpu_torch.tools.main_path import BATCH, BUCKET

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    spec = SWIN_SPECS["swin_large_384"]
    d = 32
    # (name, window, padded grid, windows, heads, blocks a forward)
    cases = [(f"stage{s}", spec.window_size, Hp, Wp, nWB, spec.num_heads[s], spec.depths[s])
             for s, (Hp, Wp, nWB) in enumerate(_swin_stage_grids(spec, BUCKET, BATCH))]
    cases.append(("n49", 7, 28, 28, 2 * 16, 6, 0))  # window 7: two images of 4 x 4 windows
    rows = []
    per_forward = {k: 0.0 for k in ("ms", "plain_ms", "library_ms", "bound_ms", "backward_ms", "backward_plain_ms",
                                    "backward_library_ms", "backward_bound_ms")}
    per_forward["calls"] = 0
    grad_check = {}
    for name, ws, Hp, Wp, nWB, h, depth in cases:
        N, C = ws * ws, h * d
        if name.startswith("stage") and N != 144:
            raise AssertionError(f"Swin-L {name} has {N} tokens a window, not the main path's 144")
        qkv = torch.randn(nWB, N, 3 * C, generator=gen, device=dev)
        bias = torch.randn(h, N, N, generator=gen, device=dev)
        shift_mask = shifted_window_mask(Hp, Wp, ws, ws // 2, dev)
        n_shifted = depth // 2 if min(Hp, Wp) > ws else 0  # the odd blocks shift
        for masked in (False, True):
            mask = shift_mask if masked else None
            calls = n_shifted if masked else depth - n_shifted
            for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
                x = qkv.to(dtype)
                before = window_attention.launches
                got = window_attention(x, bias, mask, h)
                if window_attention.launches != before + 1:
                    raise AssertionError(f"{name} {dtype} did not launch the kernel")
                want = window_attention_plain(x.float(), bias, mask, h)
                torch.cuda.synchronize()
                err = float((got.float() - want).abs().max())
                row = {"case": f"{name}/{'masked' if masked else 'unmasked'}/{str(dtype).replace('torch.', '')}",
                       "nWB": nWB, "N": N, "h": h, "max_abs_err": err, "tol": tol}
                if dtype == torch.bfloat16:  # the main path's dtype: time it
                    q, k, v = x.view(nWB, N, 3, h, d).permute(2, 0, 3, 1, 4).contiguous().unbind(0)
                    am = bias[None] if mask is None else (bias[None] + mask[:, None]).repeat(
                        nWB // mask.shape[0], 1, 1, 1)
                    am = am.to(dtype)

                    def sdpa():
                        return F.scaled_dot_product_attention(q, k, v, attn_mask=am)

                    lib = sdpa().permute(0, 2, 1, 3).reshape(nWB, N, C)
                    row["library_max_abs_err"] = float((lib.float() - want).abs().max())
                    del lib
                    row["ms"] = _cuda_ms(lambda: window_attention(x, bias, mask, h), 10)
                    row["plain_ms"] = _cuda_ms(lambda: window_attention_plain(x, bias, mask, h), 10)
                    row["library_ms"] = _cuda_ms(sdpa, 10)
                    # each input read once (qkv, bias, the mask), the output
                    # written once; 4 operations per (window, head, query,
                    # key, channel): the multiply-adds of Q K^T and of P V
                    n_bytes = sum(t.numel() * t.element_size() for t in (x, bias, got))
                    n_bytes += 0 if mask is None else mask.numel() * mask.element_size()
                    row.update(_bound(n_bytes, 4 * nWB * h * N * N * d, PEAK_BF16_TENSOR_OPS_PER_S))
                    row["calls_per_forward"] = calls
                    del q, k, v, am
                    row["backward"] = _window_backward_times(x, bias, mask, h, gen)
                    for k_ in ("ms", "plain_ms", "library_ms", "bound_ms"):
                        per_forward[k_] += calls * row[k_]
                    for k_ in ("ms", "plain_ms", "library_ms", "bound_ms"):
                        per_forward[f"backward_{k_}"] += calls * row["backward"][k_]
                    per_forward["calls"] += calls
                log(f"[window] {json.dumps(row)}")
                if not err <= tol:
                    raise AssertionError(f"window attention kernel disagrees with plain version: {row}")
                rows.append(row)
                if name == "stage3" and masked:
                    grad_check[row["case"]] = _window_grad_check(x, bias, mask, h, gen)
                del x, got, want
        del qkv, bias, shift_mask
        torch.cuda.empty_cache()
    if per_forward["calls"] != WINDOW_PER_FORWARD:
        raise AssertionError(
            f"{per_forward['calls']} window-attention calls a forward, expected {WINDOW_PER_FORWARD}")
    log(f"[window] per forward at bf16: {json.dumps(per_forward)}")
    log(f"[window] gradient through the kernel's autograd.Function: {json.dumps(grad_check)}")
    return rows, per_forward, grad_check


def _window_backward_times(x, bias, mask, h, gen) -> dict:
    """The backward of one call, timed with CUDA events on a graph kept
    from one forward: through the kernel's autograd.Function (the plain
    version recomputed, then its autograd: what a train step runs), the
    plain version's own autograd alone, and the library's,
    `scaled_dot_product_attention`'s backward on q, k, v as (nWB, h, N, d)
    with the bias (and the shift mask) as a float attn_mask that takes a
    gradient too. The bound counts each input read once (qkv, bias, mask,
    the cotangent) and each output written once (dqkv, dbias), and 8
    operations per (window, head, query, key, channel): the four matrix
    products of the backward."""
    import torch.nn.functional as F

    from rlipv2_tpu_torch.ops.window_attention import window_attention, window_attention_plain

    nWB, N, C3 = x.shape
    C, d = C3 // 3, C3 // 3 // h
    xs, bs = x.detach().requires_grad_(), bias.detach().requires_grad_()
    cot = torch.randn(nWB, N, C, generator=gen, device=x.device).to(x.dtype)
    out = window_attention(xs, bs, mask, h)
    ms = _cuda_ms(lambda: torch.autograd.grad(out, (xs, bs), cot, retain_graph=True), 5)
    del out
    out = window_attention_plain(xs, bs, mask, h)
    plain_ms = _cuda_ms(lambda: torch.autograd.grad(out, (xs, bs), cot, retain_graph=True), 5)
    del out
    q, k, v = (t.detach().requires_grad_() for t in x.view(nWB, N, 3, h, d).permute(2, 0, 3, 1, 4).contiguous()
               .unbind(0))
    am = bias[None] if mask is None else (bias[None] + mask[:, None]).repeat(nWB // mask.shape[0], 1, 1, 1)
    am = am.to(x.dtype).requires_grad_()
    out = F.scaled_dot_product_attention(q, k, v, attn_mask=am)
    lib_cot = cot.view(nWB, N, h, d).permute(0, 2, 1, 3)
    library_ms = _cuda_ms(lambda: torch.autograd.grad(out, (q, k, v, am), lib_cot, retain_graph=True), 5)
    del out, q, k, v, am
    n_bytes = 2 * x.numel() * x.element_size() + cot.numel() * cot.element_size() + 2 * bias.numel() * 4
    n_bytes += 0 if mask is None else mask.numel() * mask.element_size()
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            **_bound(n_bytes, 8 * nWB * h * N * N * d, PEAK_BF16_TENSOR_OPS_PER_S)}


def _window_grad_check(x, bias, mask, h, gen) -> dict:
    """d(qkv, bias) through the kernel's autograd.Function against autograd
    of the plain version on the same inputs: its backward is that same
    autograd, recomputed, so within 1e-5 of max|ref| per tensor."""
    from rlipv2_tpu_torch.ops.window_attention import window_attention, window_attention_plain

    xs, bs = x.detach().requires_grad_(), bias.detach().requires_grad_()
    cot = torch.randn(x.shape[0], x.shape[1], x.shape[2] // 3, generator=gen, device=x.device).to(x.dtype)
    before = window_attention.launches
    got = torch.autograd.grad(window_attention(xs, bs, mask, h), (xs, bs), cot)
    if window_attention.launches != before + 1:
        raise AssertionError("the gradient check did not launch the kernel")
    want = torch.autograd.grad(window_attention_plain(xs, bs, mask, h), (xs, bs), cot)
    torch.cuda.synchronize()
    out = {}
    for name, g, w in zip(("dqkv", "dbias"), got, want):
        err, ref = float((g.float() - w.float()).abs().max()), float(w.float().abs().max())
        out[name] = {"max_abs_err": err, "max_abs_ref": ref}
        if not err <= 1e-5 * ref:
            raise AssertionError(f"window attention gradient disagrees on {name}: {out}")
    return out


def _grads(fn, v, loc, attn, cot):
    out = fn(v, ENC_SHAPES, loc, attn)
    return torch.autograd.grad(out, (v, loc, attn), cot)


def backward_phase(l2_rate: float) -> tuple[list[dict], dict]:
    """The backward kernel against autograd of the plain version; every
    launch must take the D = 32 gather and vector scatter. Returns the
    per-case rows and the timing rows of the backward alone, bf16, B = 8:
    the encoder shape at uniform and at init-grid locations, and the
    decoder shape."""
    from rlipv2_tpu_torch.ops.ms_deform_attn import ms_deform_attn, ms_deform_attn_plain
    from rlipv2_tpu_torch.tools.main_path import BATCH

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    S = sum(h * w for h, w in ENC_SHAPES)
    cases = [
        ("encoder", dict(B=2, Q=S, lo=0.0, hi=1.0)),
        ("encoder_init_grid", dict(B=2, Q=S, lo=0.0, hi=1.0)),
        ("decoder_q200", dict(B=BATCH, Q=200, lo=0.0, hi=1.0)),
        ("out_of_bounds", dict(B=2, Q=4096, lo=-0.2, hi=1.2)),
    ]
    rows = []
    for name, c in cases:
        value, loc, attn = _msda_inputs(ENC_SHAPES, c["B"], c["Q"], 8, 32, 4, c["lo"], c["hi"], gen, dev)
        loc = _case_locations(name, loc, c["B"], c["Q"], gen)
        loc.requires_grad_()
        attn.requires_grad_()
        cot32 = torch.randn(c["B"], c["Q"], 8 * 32, generator=gen, device=dev)
        for dtype, rel in ((torch.float32, 1e-4), (torch.bfloat16, BWD_BF16_REL_TOL)):
            v, cot = value.to(dtype).detach().requires_grad_(), cot32.to(dtype)
            before = dict(ms_deform_attn.backward_designs)
            got = _grads(ms_deform_attn, v, loc, attn, cot)
            designs = _design_delta(ms_deform_attn.backward_designs, before)
            if designs != {MSDA_BWD_MAIN_DESIGN: 1}:
                raise AssertionError(f"backward {name} at D = 32 took the designs {designs}")
            v32 = v.detach().float().requires_grad_()
            want = _grads(ms_deform_attn_plain, v32, loc, attn, cot.float())
            torch.cuda.synchronize()
            errs = {k: float((g.float() - w).abs().max()) for k, g, w in zip(("dvalue", "dloc", "dattn"), got, want)}
            scale = {k: float(w.abs().max()) for k, w in zip(("dvalue", "dloc", "dattn"), want)}
            del got, want
            iters = 5 if c["Q"] > 1000 else 50
            ms = _cuda_ms(lambda: _grads(ms_deform_attn, v, loc, attn, cot), iters)
            plain_ms = _cuda_ms(lambda: _grads(ms_deform_attn_plain, v, loc, attn, cot), iters)
            row = {"case": f"{name}/{str(dtype).replace('torch.', '')}", "Q": c["Q"], "B": c["B"],
                   "design": MSDA_BWD_MAIN_DESIGN, "max_abs_err": errs, "max_abs_ref": scale, "rel_tol": rel,
                   "fwd_bwd_ms": ms, "plain_fwd_bwd_ms": plain_ms}
            log(f"[backward] {json.dumps(row)}")
            for k in errs:
                if not errs[k] <= rel * scale[k]:
                    raise AssertionError(f"backward kernel disagrees with plain version on {k}: {row}")
            rows.append(row)
        del value, loc, attn, cot32, v, cot
        torch.cuda.empty_cache()

    timing = {}
    for name, Q in (("encoder", S), ("encoder_init_grid", S), ("decoder_q200", 200)):
        timing[name] = _backward_alone(name, Q, l2_rate, gen, dev)
    return rows, timing


def _backward_alone(name: str, Q: int, l2_rate: float, gen, dev) -> dict:
    """The backward alone (autograd.grad through the kernel: the zeroed
    float32 dvalue, the kernel, the cast) at the main path's batch, bf16;
    fails unless each of dvalue, dloc and dattn is within BWD_BF16_REL_TOL
    of its max|ref| against autograd of the plain version on the same
    inputs. With its HBM bound and its L2-side bytes."""
    from rlipv2_tpu_torch.ops.ms_deform_attn import ms_deform_attn, ms_deform_attn_plain
    from rlipv2_tpu_torch.tools.main_path import BATCH

    value, loc, attn = _msda_inputs(ENC_SHAPES, BATCH, Q, 8, 32, 4, 0.0, 1.0, gen, dev)
    loc = _case_locations(name, loc, BATCH, Q, gen)
    v = value.bfloat16().requires_grad_()
    loc.requires_grad_()
    attn.requires_grad_()
    cot = torch.randn(BATCH, Q, 8 * 32, generator=gen, device=dev).bfloat16()
    out_k = ms_deform_attn(v, ENC_SHAPES, loc, attn)
    got = torch.autograd.grad(out_k, (v, loc, attn), cot, retain_graph=True)
    iters = 10 if Q > 1000 else 100
    ms = _cuda_ms(lambda: torch.autograd.grad(out_k, (v, loc, attn), cot, retain_graph=True), iters)
    out_p = ms_deform_attn_plain(v, ENC_SHAPES, loc, attn)
    want = torch.autograd.grad(out_p, (v, loc, attn), cot, retain_graph=True)
    plain_ms = _cuda_ms(lambda: torch.autograd.grad(out_p, (v, loc, attn), cot, retain_graph=True), 3)
    torch.cuda.synchronize()
    names = ("dvalue", "dloc", "dattn")
    errs = {k: float((g.float() - w.float()).abs().max()) for k, g, w in zip(names, got, want)}
    scale = {k: float(w.float().abs().max()) for k, w in zip(names, want)}
    for k in names:
        if not errs[k] <= BWD_BF16_REL_TOL * scale[k]:
            raise AssertionError(f"backward kernel disagrees with plain version on {k} at {name}, B {BATCH}: "
                                 f"max abs err {errs[k]} against max|ref| {scale[k]}")
    valid = _valid_corners(ENC_SHAPES, loc)
    # each input read once (value, loc, attn, grad_out) and each output written
    # once (dvalue in the value dtype, dloc, dattn); per valid corner and
    # channel 4 operations: the product with the cotangent and its sum, the
    # scaled cotangent and its add into dvalue
    n_bytes = sum(t.numel() * t.element_size() for t in (v, loc, attn, cot, *got))
    row = {"case": f"{name}/bfloat16", "B": BATCH, "Q": Q, "design": MSDA_BWD_MAIN_DESIGN, "ms": ms,
           "plain_ms": plain_ms, "max_abs_err": max(errs.values()), "max_abs_err_by_grad": errs,
           "max_abs_ref": scale, "rel_tol": BWD_BF16_REL_TOL, **_bound(n_bytes, 4 * 32 * valid)}
    # the L2 side: four bf16 corner rows gathered for every sample (an
    # invalid corner reads a clamped row), one float32 row reduced into
    # dvalue for every valid corner, plus loc, attn, grad_out, dloc and dattn
    row["l2_bytes"] = (attn.numel() * 4 * 32 * v.element_size() + valid * 32 * 4
                       + sum(t.numel() * t.element_size() for t in (loc, attn, cot, got[1], got[2])))
    row["l2_read_rate"] = l2_rate
    row["l2_ms"] = 1e3 * row["l2_bytes"] / l2_rate
    log(f"[backward] alone: {json.dumps(row)}")
    del out_k, out_p, got, want, value, loc, attn, v, cot
    torch.cuda.empty_cache()
    return row


def train_phase() -> dict:
    from rlipv2_tpu_torch.engine.loops import train_one_epoch
    from rlipv2_tpu_torch.engine.optim import param_group_name
    from rlipv2_tpu_torch.ops.ms_deform_attn import ms_deform_attn
    from rlipv2_tpu_torch.ops.window_attention import window_attention
    from rlipv2_tpu_torch.tools.main_path import BATCH, BUCKET, main_train_data, main_train_step

    t0 = time.perf_counter()
    cfg, model, train_step = main_train_step("cuda")
    dataset, text_encoder = main_train_data(cfg, model, BATCH * TRAIN_STEPS)
    frozen = {k: t.detach().clone() for k, t in model.named_buffers()}
    frozen.update({k: p.detach().clone() for k, p in model.named_parameters() if not p.requires_grad})
    trainable = {k: p.detach().clone() for k, p in model.named_parameters() if p.requires_grad}
    log(f"[train] model, data and text cache ready in {time.perf_counter() - t0:.1f} s; "
        f"{len(trainable)} trainable, {len(frozen)} frozen tensors")

    steps = []

    def step_fn(batch):
        if tuple(batch.pixels.shape[1:3]) != BUCKET:
            raise AssertionError(f"train batch in bucket {tuple(batch.pixels.shape[1:3])}, not {BUCKET}")
        before = (ms_deform_attn.launches, ms_deform_attn.backward_launches)
        torch.cuda.synchronize()
        t = time.perf_counter()
        metrics = step_fn.train_step(batch)
        torch.cuda.synchronize()
        steps.append({
            "s": time.perf_counter() - t,
            "fwd": ms_deform_attn.launches - before[0],
            "bwd": ms_deform_attn.backward_launches - before[1],
            **{k: float(metrics[k]) for k in ("loss", "grad_norm", "nonfinite")},
        })
        for k, v in metrics.items():
            if not math.isfinite(float(v)):
                raise AssertionError(f"train step {len(steps)}: non-finite {k}")
        return metrics

    step_fn.train_step = train_step
    torch.cuda.reset_peak_memory_stats()
    ms_deform_attn.launches = ms_deform_attn.backward_launches = ms_deform_attn.int8_launches = 0
    window_attention.launches = 0
    _zero_msda_designs()
    t0 = time.perf_counter()
    _, stats = train_one_epoch(step_fn, model, dataset, list(range(len(dataset))), BATCH, cfg,
                               text_encoder, num_workers=2, print_freq=1)
    wall = time.perf_counter() - t0
    launches = {"fwd": ms_deform_attn.launches, "bwd": ms_deform_attn.backward_launches,
                "window": window_attention.launches, "int8": ms_deform_attn.int8_launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    designs = _check_designs("train", launches["fwd"], {}, msda_bwd=launches["bwd"])

    if len(steps) != TRAIN_STEPS:
        raise AssertionError(f"{len(steps)} train steps, expected {TRAIN_STEPS}")
    per_step = [(s["fwd"], s["bwd"]) for s in steps]
    if per_step != [(MSDA_PER_FORWARD, MSDA_PER_FORWARD)] * TRAIN_STEPS or launches != {
            "fwd": MSDA_PER_FORWARD * TRAIN_STEPS, "bwd": MSDA_PER_FORWARD * TRAIN_STEPS, "window": 0, "int8": 0}:
        raise AssertionError(f"kernel launches per step {per_step}, total {launches}")
    if any(s["nonfinite"] != 0.0 for s in steps):
        raise AssertionError(f"a step skipped its update: {steps}")
    state = model.state_dict()
    changed = [k for k, v in frozen.items() if not torch.equal(state[k], v)]
    if changed:
        raise AssertionError(f"frozen tensors changed: {changed[:5]}")
    moved = {}
    for k, p in model.named_parameters():
        if p.requires_grad:
            g = param_group_name(k)
            moved[g] = moved.get(g, False) or not torch.equal(p.detach(), trainable[k])
    # the text encoder group moves only when its features are computed in
    # the graph; with cached text features it gets no gradient
    expected = {"model": True, "backbone": True, "text_encoder": False}
    if moved != expected:
        raise AssertionError(f"groups moved {moved}, expected {expected}")
    steady = [s["s"] for s in steps[1:]]  # the first step is warm-up
    result = {
        "step_p50_ms": 1000 * float(np.median(steady)),
        "img_per_s": BATCH * len(steady) / sum(steady),
        "warmup_ms": 1000 * steps[0]["s"],
        "peak_mem_gb": peak_gb,
        "train_wall_s": wall,
        "launches": launches,
        "designs": designs,
        "losses": [s["loss"] for s in steps],
        "grad_norms": [s["grad_norm"] for s in steps],
        "stats": stats,
        "groups_moved": moved,
    }
    log(f"[train] {json.dumps(result)}")
    return result


def _nvjpeg_check() -> dict:
    """Each JPEG fixture through the HICO loader's reader (nvJPEG on the
    card): its seeded source regenerated by numpy, PSNR at least
    MIN_PSNR_DB, two decodes bit-equal, and the time a decode takes on this
    thread (the file's bytes in memory, the copy back to the host
    included); the CMYK file must raise, naming itself."""
    from rlipv2_tpu_torch.data.image_io import NvJpegDecoder
    from rlipv2_tpu_torch.tools.hico_fixture import (
        CMYK_FIXTURE, FIXTURE_DIR, FIXTURES, MIN_PSNR_DB, psnr_db, source_image)

    decoder = NvJpegDecoder("cuda")
    files, times = {}, []
    try:
        for spec in FIXTURES:
            data = (FIXTURE_DIR / spec.name).read_bytes()
            a, b = decoder.decode(data, spec.name), decoder.decode(data, spec.name)
            psnr = psnr_db(a.numpy(), source_image(spec))
            if tuple(a.shape) != (spec.height, spec.width, 3) or psnr < MIN_PSNR_DB or not torch.equal(a, b):
                raise AssertionError(f"[nvjpeg] {spec.name}: shape {tuple(a.shape)}, PSNR {psnr:.2f} dB, "
                                     f"bit-equal {torch.equal(a, b)}")
            for _ in range(10):
                t = time.perf_counter()
                decoder.decode(data, spec.name)
                times.append(time.perf_counter() - t)
            files[spec.name] = {"psnr_db": psnr, "subsampling": spec.subsampling}
        try:
            decoder.decode((FIXTURE_DIR / CMYK_FIXTURE).read_bytes(), CMYK_FIXTURE)
        except ValueError as e:
            if CMYK_FIXTURE not in str(e):
                raise
        else:
            raise AssertionError(f"[nvjpeg] the CMYK file {CMYK_FIXTURE} decoded")
    finally:
        decoder.close()
    result = {"files": files, "ms_per_image_p50": 1000 * float(np.median(times)), "min_psnr_db": MIN_PSNR_DB}
    log(f"[nvjpeg] {json.dumps(result)}")
    return result


def finetune_phase(shared: str) -> tuple:
    """Phase 8: `rlipv2_tpu_torch.cli.main`, the R50 HICO-DET fine-tune of
    scripts/finetune_hico_parseda_r50.sh, on a HICO tree from the JPEG
    fixture whose parts go to `shared` (`main_finetune_tree`): train 5
    steps and save, resume for 3 more and save, then evaluate the last
    checkpoint. Returns (result, the temporary
    directory of the tree, which phase 14 runs on again; the runs' outputs
    are removed)."""
    import shutil
    import tempfile
    from pathlib import Path

    from rlipv2_tpu_torch import cli
    from rlipv2_tpu_torch.engine import loops
    from rlipv2_tpu_torch.engine.checkpoint import CheckpointManager
    from rlipv2_tpu_torch.engine.optim import param_group_name
    from rlipv2_tpu_torch.ops.ms_deform_attn import ms_deform_attn
    from rlipv2_tpu_torch.ops.window_attention import window_attention
    from rlipv2_tpu_torch.tools.main_path import BATCH, PRETRAINED_QUERIES, main_finetune_tree

    nvjpeg = _nvjpeg_check()
    tmp = tempfile.TemporaryDirectory(prefix="finetune_hico_")
    root = Path(tmp.name)
    t0 = time.perf_counter()
    flags, initial = main_finetune_tree(root, FINETUNE_TRAIN_IMAGES, FINETUNE_VAL_IMAGES, shared=shared)
    log(f"[finetune] HICO tree, tokenizer and pretrained.pth ({PRETRAINED_QUERIES} queries) written "
        f"in {time.perf_counter() - t0:.1f} s")
    common = flags + ["--num_workers", "2", "--lr_drop", "1", "--output_dir"]
    steps, evals = [], []

    def instrumented(step_fn, *args, **kwargs):
        """`train_one_epoch` with each step timed and its launches counted."""
        def step(batch):
            before = (ms_deform_attn.launches, ms_deform_attn.backward_launches)
            torch.cuda.synchronize()
            t = time.perf_counter()
            # the loop's time between two steps: the wait for the batch and
            # its copy to the card (none before a run's first step)
            gap = t - step.end if step.end is not None else None
            metrics = step_fn(batch)
            torch.cuda.synchronize()
            step.end = time.perf_counter()
            steps.append({"s": step.end - t, "gap_s": gap, "fwd": ms_deform_attn.launches - before[0],
                          "bwd": ms_deform_attn.backward_launches - before[1],
                          "bucket": list(batch.pixels.shape[1:3]),
                          **{k: float(metrics[k]) for k in ("loss", "grad_norm", "nonfinite")}})
            if batch.token_ids is None:
                raise AssertionError("the fine-tune step got no slot tokens: the text encoder is not in the graph")
            return metrics

        step.ema_params, step.end = step_fn.ema_params, None
        return train_one_epoch(step, *args, **kwargs)

    def counted_apply(m, *a):
        evals.append(ms_deform_attn.launches)
        out = m(*a)
        evals[-1] = ms_deform_attn.launches - evals[-1]
        return out

    train_one_epoch, evaluate_hoi = loops.train_one_epoch, loops.evaluate_hoi

    def evaluate(apply_fn, *args, **kwargs):
        return evaluate_hoi(counted_apply, *args, **kwargs)

    torch.cuda.reset_peak_memory_stats()
    ms_deform_attn.launches = ms_deform_attn.backward_launches = ms_deform_attn.int8_launches = 0
    window_attention.launches = 0
    _zero_msda_designs()
    loops.train_one_epoch, loops.evaluate_hoi = instrumented, evaluate
    t0 = time.perf_counter()
    try:
        run_a = cli.main(common + [str(root / "a"), "--epochs", "1", "--max_steps", str(FINETUNE_STEPS[0])])
        wall_a = time.perf_counter() - t0
        saved_a = {"step": run_a.state.lr_scheduler.last_epoch,
                   "lr": {g["name"]: g["lr"] for g in run_a.state.optimizer.param_groups}}
        state_a = {k: v.detach().cpu().clone() for k, v in run_a.state.model.state_dict().items()}
        trainable = {k for k, p in run_a.state.model.named_parameters(remove_duplicate=False) if p.requires_grad}
        del run_a
        run_b = cli.main(common + [str(root / "b"), "--resume", str(root / "a" / "ckpt"),
                                   "--epochs", "2", "--max_steps", str(FINETUNE_STEPS[1])])
        resumed_b, last_b = run_b.resumed, run_b.state.lr_scheduler.last_epoch
        # the checkpoint's own cost: one more save of the trained state
        # (model, AdamW moments, scheduler), and a restore into it
        mgr = CheckpointManager(root / "timing")
        t = time.perf_counter()
        ckpt_path = mgr.save(0, run_b.state)
        save_s = time.perf_counter() - t
        before = {k: v.detach().clone() for k, v in run_b.state.model.state_dict().items()}
        t = time.perf_counter()
        mgr.restore(run_b.state)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t
        unequal = [k for k, v in run_b.state.model.state_dict().items() if not torch.equal(v, before[k])]
        if unequal:
            raise AssertionError(f"[finetune] a save and restore changed {unequal[:5]}")
        del run_b, before
        run_c = cli.main(common + [str(root / "c"), "--resume", str(root / "b" / "ckpt"), "--eval"])
    finally:
        loops.train_one_epoch, loops.evaluate_hoi = train_one_epoch, evaluate_hoi
    wall = time.perf_counter() - t0
    launches = {"fwd": ms_deform_attn.launches, "bwd": ms_deform_attn.backward_launches,
                "window": window_attention.launches, "int8": ms_deform_attn.int8_launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    designs = _check_designs("finetune_hico", launches["fwd"], {}, msda_bwd=launches["bwd"])

    n_steps = sum(FINETUNE_STEPS)
    if len(steps) != n_steps or any((s["fwd"], s["bwd"]) != (MSDA_PER_FORWARD,) * 2 for s in steps):
        raise AssertionError(f"[finetune] launches per step {[(s['fwd'], s['bwd']) for s in steps]}")
    if any(e != MSDA_PER_FORWARD for e in evals) or launches != {
            "fwd": MSDA_PER_FORWARD * (n_steps + len(evals)), "bwd": MSDA_PER_FORWARD * n_steps,
            "window": 0, "int8": 0}:
        raise AssertionError(f"[finetune] launches per eval forward {evals}, total {launches}")
    if any(s["nonfinite"] != 0.0 or not math.isfinite(s["loss"]) for s in steps):
        raise AssertionError(f"[finetune] a step skipped its update or lost its loss: {steps}")
    changed = [k for k in state_a if k not in trainable and not torch.equal(state_a[k], initial[k])]
    if changed:
        raise AssertionError(f"[finetune] frozen tensors changed: {changed[:5]}")
    moved = {}
    for k in trainable:
        g = param_group_name(k)
        moved[g] = moved.get(g, False) or not torch.equal(state_a[k], initial[k])
    if moved != {"model": True, "backbone": True, "text_encoder": True}:
        raise AssertionError(f"[finetune] groups moved {moved}: every group, the text encoder too, must move")
    if resumed_b != {"epoch": 0, **saved_a} or last_b != saved_a["step"] + FINETUNE_STEPS[1]:
        raise AssertionError(f"[finetune] resumed at {resumed_b} after saving {saved_a}; step {last_b} at the end")
    # the weights the evaluation restored against the file, bit for bit
    ckpt_b = root / "b" / "ckpt" / "checkpoint0001.pth"
    saved_b = torch.load(ckpt_b, map_location="cpu", weights_only=True)
    restored = run_c.state.model.state_dict()
    unequal = [k for k, v in saved_b["model"].items() if not torch.equal(restored[k].cpu(), v)]
    if unequal or set(restored) != set(saved_b["model"]):
        raise AssertionError(f"[finetune] restored weights differ from the checkpoint: {unequal[:5]}")
    for k, v in run_c.stats.items():
        if not (math.isfinite(v) and 0.0 <= v <= 1.0):
            raise AssertionError(f"[finetune] HICO stat {k} = {v}")
    del saved_b, restored
    log_lines = [json.loads(x) for x in (root / "b" / "log.txt").read_text().splitlines()]
    host_wait = [json.loads(x)["train"]["host_wait_s"] for x in
                 (root / "a" / "log.txt").read_text().splitlines()] + [x["train"]["host_wait_s"] for x in log_lines]
    steady = [s["s"] for s in steps[1:]]  # the first step is warm-up
    landscape_bucket = [s["s"] for s in steps[1:] if s["bucket"] == [832, 1344]]
    gaps = [s["gap_s"] for s in steps if s["gap_s"] is not None]
    result = {
        "step_p50_ms": 1000 * float(np.median(steady)),
        "step_p50_ms_832x1344": 1000 * float(np.median(landscape_bucket)) if landscape_bucket else None,
        "img_per_s": BATCH * len(steady) / sum(steady),
        "warmup_ms": 1000 * steps[0]["s"],
        "step_ms": [1000 * s["s"] for s in steps],
        "gap_between_steps_ms": [1000 * g for g in gaps],
        "host_wait_ms_per_epoch_mean": [1000 * w for w in host_wait],
        "peak_mem_gb": peak_gb,
        "wall_s": wall,
        "train_a_wall_s": wall_a,
        "nvjpeg": nvjpeg,
        "checkpoint_gb": ckpt_path.stat().st_size / 1e9,
        "checkpoint_save_s": save_s,
        "checkpoint_restore_s": restore_s,
        "launches": launches,
        "designs": designs,
        "eval_forwards": len(evals),
        "buckets": [s["bucket"] for s in steps],
        "losses": [s["loss"] for s in steps],
        "grad_norms": [s["grad_norm"] for s in steps],
        "saved": saved_a,
        "resumed": resumed_b,
        "groups_moved": moved,
        "stats": run_c.stats,
    }
    del run_c
    for run in ("a", "b", "timing"):  # the checkpoints; the tree, tokenizer and pretrained.pth stay
        shutil.rmtree(root / run)
    log(f"[finetune] {json.dumps(result)}")
    return result, tmp


def pretrain_phase() -> dict:
    """Phase 9: `rlipv2_tpu_torch.cli.main`, the mixed VG + COCO relational
    pre-training of scripts/pretrain_mixed_vgcoco_parseda_r50.sh, on a tree
    written here from the JPEG fixture: 4 optimizer steps of two
    micro-batches and a checkpoint, then --resume for 2 more."""
    import tempfile
    from pathlib import Path

    from torch.optim.optimizer import register_optimizer_step_pre_hook

    from rlipv2_tpu_torch import cli
    from rlipv2_tpu_torch.engine import loops
    from rlipv2_tpu_torch.engine.checkpoint import CheckpointManager
    from rlipv2_tpu_torch.engine.optim import param_group_name
    from rlipv2_tpu_torch.losses.matcher import triplet_filter
    from rlipv2_tpu_torch.ops.ms_deform_attn import ms_deform_attn
    from rlipv2_tpu_torch.ops.window_attention import window_attention
    from rlipv2_tpu_torch.tools.main_path import BATCH, main_pretrain_tree

    tmp = tempfile.TemporaryDirectory(prefix="pretrain_mixed_")
    root = Path(tmp.name)
    t0 = time.perf_counter()
    flags, initial, tree = main_pretrain_tree(root)
    n_vg = len(json.loads(Path(tree["vg_anno"]).read_text()))
    log(f"[pretrain_mixed] VG tree ({n_vg} VG and as many COCO images), tokenizer and pretrained.pth written "
        f"in {time.perf_counter() - t0:.1f} s")
    common = flags + ["--num_workers", "2", "--lr_drop", "1", "--output_dir"]
    steps, groups = [], []

    def instrumented(step_fn, model, dataset, *args, **kwargs):
        """`train_one_epoch` with each optimizer step timed on the host,
        each micro-batch on the device (CUDA events where it starts to
        encode its slot texts and where the optimizer starts), the step's
        launches counted, and the datasets of each group that runs."""
        vg_size = int(dataset.cumsizes[0])
        groups.extend([[int(i) < vg_size for i in ids] for ids in group]
                      for group in kwargs["batch_lists"][: kwargs["max_steps"]])
        encode_text, events = model.encode_text, []

        def mark(*_):
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()

        def timed_encode(*a, **k):
            mark()
            return encode_text(*a, **k)

        def step(group):
            before = (ms_deform_attn.launches, ms_deform_attn.backward_launches)
            events.clear()
            torch.cuda.synchronize()
            t = time.perf_counter()
            gap = t - step.end if step.end is not None else None
            metrics = step_fn(group)
            torch.cuda.synchronize()
            step.end = time.perf_counter()
            micro_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
            steps.append({"s": step.end - t, "gap_s": gap, "micro_ms": micro_ms,
                          "fwd": ms_deform_attn.launches - before[0],
                          "bwd": ms_deform_attn.backward_launches - before[1],
                          "micro": len(group), "text_slots": [int(b.text_valid.shape[1]) for b in group],
                          "buckets": [list(b.pixels.shape[1:3]) for b in group],
                          **{k: float(metrics[k]) for k in ("loss", "grad_norm", "nonfinite")}})
            if len(micro_ms) != len(group):
                raise AssertionError(f"[pretrain_mixed] {len(events)} timing marks for {len(group)} micro-batches: "
                                     "the step did not encode its slot texts in the graph")
            return metrics

        step.ema_params, step.end = step_fn.ema_params, None
        model.encode_text = timed_encode
        hook = register_optimizer_step_pre_hook(mark)
        try:
            return train_one_epoch(step, model, dataset, *args, **kwargs)
        finally:
            hook.remove()
            del model.encode_text

    train_one_epoch = loops.train_one_epoch
    torch.cuda.reset_peak_memory_stats()
    ms_deform_attn.launches = ms_deform_attn.backward_launches = ms_deform_attn.int8_launches = 0
    window_attention.launches = 0
    _zero_msda_designs()
    triplet_filter.counts.update(dict.fromkeys(triplet_filter.counts, 0))
    loops.train_one_epoch = instrumented
    t0 = time.perf_counter()
    try:
        run_a = cli.main(common + [str(root / "a"), "--epochs", "1", "--max_steps", str(PRETRAIN_STEPS[0])])
        wall_a = time.perf_counter() - t0
        slots = (run_a.state.model.cfg.max_obj_texts, run_a.state.model.cfg.max_verb_texts)
        saved_a = {"step": run_a.state.lr_scheduler.last_epoch,
                   "lr": {g["name"]: g["lr"] for g in run_a.state.optimizer.param_groups}}
        state_a = {k: v.detach().cpu().clone() for k, v in run_a.state.model.state_dict().items()}
        trainable = {k for k, p in run_a.state.model.named_parameters(remove_duplicate=False) if p.requires_grad}
        del run_a
        run_b = cli.main(common + [str(root / "b"), "--resume", str(root / "a" / "ckpt"),
                                   "--epochs", "2", "--max_steps", str(PRETRAIN_STEPS[1])])
        resumed_b, last_b = run_b.resumed, run_b.state.lr_scheduler.last_epoch
        mgr = CheckpointManager(root / "timing")
        t = time.perf_counter()
        ckpt_path = mgr.save(0, run_b.state)
        save_s = time.perf_counter() - t
        before = {k: v.detach().clone() for k, v in run_b.state.model.state_dict().items()}
        t = time.perf_counter()
        mgr.restore(run_b.state)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t
        unequal = [k for k, v in run_b.state.model.state_dict().items() if not torch.equal(v, before[k])]
        if unequal:
            raise AssertionError(f"[pretrain_mixed] a save and restore changed {unequal[:5]}")
        del run_b, before
    finally:
        loops.train_one_epoch = train_one_epoch
    wall = time.perf_counter() - t0
    launches = {"fwd": ms_deform_attn.launches, "bwd": ms_deform_attn.backward_launches,
                "window": window_attention.launches, "int8": ms_deform_attn.int8_launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    designs = _check_designs("pretrain_mixed", launches["fwd"], {}, msda_bwd=launches["bwd"])
    filtered = dict(triplet_filter.counts)

    n_steps, per_step = sum(PRETRAIN_STEPS), MSDA_PER_FORWARD * PRETRAIN_MICRO
    if len(steps) != n_steps or any((s["fwd"], s["bwd"], s["micro"]) != (per_step, per_step, PRETRAIN_MICRO)
                                    for s in steps):
        raise AssertionError(f"[pretrain_mixed] launches per step "
                             f"{[(s['fwd'], s['bwd'], s['micro']) for s in steps]}")
    if launches != {"fwd": per_step * n_steps, "bwd": per_step * n_steps, "window": 0, "int8": 0}:
        raise AssertionError(f"[pretrain_mixed] launches {launches}")
    # every group that ran: a VG micro-batch, then a COCO one
    if len(groups) != n_steps or any([all(g[0]), any(g[1])] != [True, False] for g in groups):
        raise AssertionError(f"[pretrain_mixed] a group is not one VG and one COCO micro-batch: {groups}")
    if slots != PRETRAIN_SLOTS or any(s["text_slots"] != [sum(PRETRAIN_SLOTS)] * PRETRAIN_MICRO for s in steps):
        raise AssertionError(f"[pretrain_mixed] text slots {slots}, per batch {[s['text_slots'] for s in steps]}")
    if any(s["nonfinite"] != 0.0 or not math.isfinite(s["loss"]) for s in steps):
        raise AssertionError(f"[pretrain_mixed] a step skipped its update or lost its loss: {steps}")
    if not 0 < filtered["kept"] < filtered["valid"] or filtered["calls"] != n_steps * PRETRAIN_MICRO:
        raise AssertionError(f"[pretrain_mixed] the triplet filter kept {filtered}")
    changed = [k for k in state_a if k not in trainable and not torch.equal(state_a[k], initial[k])]
    if changed:
        raise AssertionError(f"[pretrain_mixed] frozen tensors changed: {changed[:5]}")
    moved = {}
    for k in trainable:
        g = param_group_name(k)
        moved[g] = moved.get(g, False) or not torch.equal(state_a[k], initial[k])
    if moved != {"model": True, "backbone": True, "text_encoder": True}:
        raise AssertionError(f"[pretrain_mixed] groups moved {moved}: every group, the text encoder too, must move")
    if resumed_b != {"epoch": 0, **saved_a} or last_b != saved_a["step"] + PRETRAIN_STEPS[1]:
        raise AssertionError(f"[pretrain_mixed] resumed at {resumed_b} after saving {saved_a}; step {last_b} at the end")
    log_lines = [json.loads(x) for d in ("a", "b") for x in (root / d / "log.txt").read_text().splitlines()]
    if [x["text_slots"] for x in log_lines] != [{"obj": PRETRAIN_SLOTS[0], "verb": PRETRAIN_SLOTS[1]}] * 2:
        raise AssertionError(f"[pretrain_mixed] log lines {log_lines}")
    steady = [s["s"] for s in steps[1:]]  # the first step is warm-up
    micro = [m for s in steps[1:] for m in s["micro_ms"]]
    gaps = [s["gap_s"] for s in steps if s["gap_s"] is not None]
    result = {
        "step_p50_ms": 1000 * float(np.median(steady)),
        "micro_batch_p50_ms": float(np.median(micro)),
        "img_per_s": BATCH * PRETRAIN_MICRO * len(steady) / sum(steady),
        "warmup_ms": 1000 * steps[0]["s"],
        "step_ms": [1000 * s["s"] for s in steps],
        "micro_batch_ms": [s["micro_ms"] for s in steps],
        "gap_between_steps_ms": [1000 * g for g in gaps],
        "host_wait_ms_per_epoch_mean": [1000 * x["train"]["host_wait_s"] for x in log_lines],
        "peak_mem_gb": peak_gb,
        "wall_s": wall,
        "train_a_wall_s": wall_a,
        "text_slots": {"obj": slots[0], "verb": slots[1]},
        "triplet_filter": {**filtered, "filtered_share": 1.0 - filtered["kept"] / filtered["valid"],
                           "triplets_per_micro_batch": filtered["valid"] / filtered["calls"]},
        "checkpoint_gb": ckpt_path.stat().st_size / 1e9,
        "checkpoint_save_s": save_s,
        "checkpoint_restore_s": restore_s,
        "launches": launches,
        "designs": designs,
        "buckets": [s["buckets"] for s in steps],
        "losses": [s["loss"] for s in steps],
        "grad_norms": [s["grad_norm"] for s in steps],
        "saved": saved_a,
        "resumed": resumed_b,
        "groups_moved": moved,
    }
    tmp.cleanup()
    log(f"[pretrain_mixed] {json.dumps(result)}")
    return result


def swin_train_phase(tag: str, script: str, steps: tuple, micro: int, evaluate: bool,
                     use_checkpoint: bool) -> dict:
    """Phase 10: `rlipv2_tpu_torch.cli.main` running `script` with the
    Swin-L preset (`tools/main_path.py`: "finetune_hico_swinL",
    scripts/finetune_hico_swinL.sh, on the HICO tree; or
    "pretrain_mixed_vgcocoo365_swinL" on the VG, COCO and O365 tree) and
    `backbone.use_checkpoint` given through `model_cfg`: steps[0]
    optimizer steps of `micro` micro-batches and a
    checkpoint, then --resume for steps[1], then with `evaluate` --eval
    --resume of the last checkpoint. Every step must launch the MSDA
    forward kernel 12 times a micro-batch (the encoder's recompute keeps
    its output: none again), the backward kernel 12 times, and window
    attention 24 times (48 with the blocks rematerialized) on bf16 windows
    of 144 tokens, whose backward (the plain version's autograd, counted
    by `window_attention.backward_calls`) runs 24 times; an evaluation
    forward 12, 24 and no backward."""
    import tempfile
    from pathlib import Path

    from rlipv2_tpu_torch import cli
    from rlipv2_tpu_torch.config import PRESETS
    from rlipv2_tpu_torch.engine import loops
    from rlipv2_tpu_torch.engine.optim import param_group_name
    from rlipv2_tpu_torch.ops.ms_deform_attn import ms_deform_attn
    from rlipv2_tpu_torch.ops.window_attention import window_attention
    from rlipv2_tpu_torch.tools.main_path import (BATCH, FINETUNE_SCRIPTS, PRETRAIN_SCRIPTS, main_finetune_tree,
                                                  main_pretrain_tree, with_swin_checkpoint)

    tmp = tempfile.TemporaryDirectory(prefix=f"{tag}_")
    root = Path(tmp.name)
    t0 = time.perf_counter()
    if evaluate:
        flags, initial = main_finetune_tree(root, SWIN_FINETUNE_TRAIN_IMAGES, SWIN_FINETUNE_VAL_IMAGES, script)
        preset = FINETUNE_SCRIPTS[script][0]
    else:
        flags, initial, _ = main_pretrain_tree(root, script)
        preset = PRETRAIN_SCRIPTS[script][0]
    model_cfg = with_swin_checkpoint(PRESETS[preset](), use_checkpoint)
    log(f"[{tag}] data, tokenizer and pretrained.pth ({preset}) written in {time.perf_counter() - t0:.1f} s")
    common = flags + ["--num_workers", "2", "--lr_drop", "1", "--output_dir"]
    window_per_micro = WINDOW_PER_FORWARD * (2 if use_checkpoint else 1)
    want_step = {"msda_fwd": MSDA_PER_FORWARD * micro, "msda_bwd": MSDA_PER_FORWARD * micro,
                 "window": window_per_micro * micro, "window_bwd": WINDOW_PER_FORWARD * micro}
    steps_log, evals = [], []

    def counts():
        return {"msda_fwd": ms_deform_attn.launches, "msda_bwd": ms_deform_attn.backward_launches,
                "window": window_attention.launches, "window_bwd": window_attention.backward_calls}

    def instrumented(step_fn, *args, **kwargs):
        def step(batch):
            group = batch if micro > 1 else [batch]
            before = counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            gap = t - step.end if step.end is not None else None
            metrics = step_fn(batch)
            torch.cuda.synchronize()
            step.end = time.perf_counter()
            steps_log.append({"s": step.end - t, "gap_s": gap, **{k: v - before[k] for k, v in counts().items()},
                              "buckets": [list(b.pixels.shape[1:3]) for b in group],
                              **{k: float(metrics[k]) for k in ("loss", "grad_norm", "nonfinite")}})
            if any(b.token_ids is None for b in group):
                raise AssertionError(f"[{tag}] a micro-batch got no slot tokens: the text encoder is not in the graph")
            return metrics

        step.ema_params, step.end = step_fn.ema_params, None
        if step.ema_params is None:
            raise AssertionError(f"[{tag}] the step keeps no EMA: --ema did not reach it")
        return train_one_epoch(step, *args, **kwargs)

    def counted_apply(m, *a):
        before = counts()
        out = m(*a)
        evals.append({k: v - before[k] for k, v in counts().items()})
        return out

    train_one_epoch, evaluate_hoi = loops.train_one_epoch, loops.evaluate_hoi

    def evaluate_counted(apply_fn, *args, **kwargs):
        return evaluate_hoi(counted_apply, *args, **kwargs)

    torch.cuda.reset_peak_memory_stats()
    ms_deform_attn.launches = ms_deform_attn.backward_launches = ms_deform_attn.int8_launches = 0
    window_attention.launches = window_attention.backward_calls = 0
    _zero_msda_designs()
    loops.train_one_epoch, loops.evaluate_hoi = instrumented, evaluate_counted
    t0 = time.perf_counter()
    try:
        with _window_launch_shapes() as window_shapes:
            run_a = cli.main(common + [str(root / "a"), "--epochs", "1", "--max_steps", str(steps[0])],
                             model_cfg=model_cfg)
            cfg = run_a.state.model.cfg
            saved_a = {"step": run_a.state.lr_scheduler.last_epoch,
                       "lr": {g["name"]: g["lr"] for g in run_a.state.optimizer.param_groups}}
            state_a = {k: v.detach().cpu().clone() for k, v in run_a.state.model.state_dict().items()}
            trainable = {k for k, p in run_a.state.model.named_parameters(remove_duplicate=False) if p.requires_grad}
            del run_a
            run_b = cli.main(common + [str(root / "b"), "--resume", str(root / "a" / "ckpt"),
                                       "--epochs", "2", "--max_steps", str(steps[1])], model_cfg=model_cfg)
            resumed_b, last_b = run_b.resumed, run_b.state.lr_scheduler.last_epoch
            ckpt_b = run_b.checkpoints[-1]
            del run_b
            stats = None
            if evaluate:
                run_c = cli.main(common + [str(root / "c"), "--resume", str(ckpt_b), "--eval"], model_cfg=model_cfg)
                stats = run_c.stats
                saved_b = torch.load(ckpt_b, map_location="cpu", weights_only=True)["model"]
                restored = run_c.state.model.state_dict()
                unequal = [k for k, v in saved_b.items() if not torch.equal(restored[k].cpu(), v)]
                if unequal or set(restored) != set(saved_b):
                    raise AssertionError(f"[{tag}] restored weights differ from the checkpoint: {unequal[:5]}")
                del run_c, saved_b, restored
    finally:
        loops.train_one_epoch, loops.evaluate_hoi = train_one_epoch, evaluate_hoi
    wall = time.perf_counter() - t0
    launches = {**counts(), "msda_int8": ms_deform_attn.int8_launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    designs = _check_designs(tag, launches["msda_fwd"], window_shapes, msda_bwd=launches["msda_bwd"])
    if sum(window_shapes.values()) != launches["window"]:
        raise AssertionError(f"[{tag}] window launches {window_shapes} against the count {launches['window']}")

    n_steps = sum(steps)
    per_step = [{k: s[k] for k in want_step} for s in steps_log]
    if len(steps_log) != n_steps or per_step != [want_step] * n_steps:
        raise AssertionError(f"[{tag}] launches per optimizer step {per_step}, expected {want_step} x {n_steps}")
    want_eval = {"msda_fwd": MSDA_PER_FORWARD, "msda_bwd": 0, "window": WINDOW_PER_FORWARD, "window_bwd": 0}
    if (evaluate and not evals) or any(e != want_eval for e in evals):
        raise AssertionError(f"[{tag}] launches per evaluation forward {evals}, expected {want_eval}")
    total = {k: v * n_steps + sum(e[k] for e in evals) for k, v in want_step.items()}
    if launches != {**total, "msda_int8": 0}:
        raise AssertionError(f"[{tag}] launches {launches}, expected {total}")
    if cfg.backbone.use_checkpoint != use_checkpoint or not cfg.transformer.remat_encoder:
        raise AssertionError(f"[{tag}] backbone.use_checkpoint {cfg.backbone.use_checkpoint}, "
                             f"remat_encoder {cfg.transformer.remat_encoder}")
    if any(s["nonfinite"] != 0.0 or not math.isfinite(s["loss"]) for s in steps_log):
        raise AssertionError(f"[{tag}] a step skipped its update or lost its loss: {steps_log}")
    changed = [k for k in state_a if k not in trainable and not torch.equal(state_a[k], initial[k])]
    if changed:
        raise AssertionError(f"[{tag}] frozen tensors changed: {changed[:5]}")
    moved = {}
    for k in trainable:
        g = param_group_name(k)
        moved[g] = moved.get(g, False) or not torch.equal(state_a[k], initial[k])
    if moved != {"model": True, "backbone": True, "text_encoder": True}:
        raise AssertionError(f"[{tag}] groups moved {moved}: every group, the Swin backbone and the text encoder "
                             "too, must move")
    if any(k.startswith("backbone.") and k not in trainable for k in state_a if "running_" not in k):
        raise AssertionError(f"[{tag}] a Swin parameter is frozen")
    if resumed_b != {"epoch": 0, **saved_a} or last_b != saved_a["step"] + steps[1]:
        raise AssertionError(f"[{tag}] resumed at {resumed_b} after saving {saved_a}; step {last_b} at the end")
    for k, v in (stats or {}).items():
        if not (math.isfinite(v) and 0.0 <= v <= 1.0):
            raise AssertionError(f"[{tag}] HICO stat {k} = {v}")
    steady = [s["s"] for s in steps_log[1:]]  # the first step is warm-up
    gaps = [s["gap_s"] for s in steps_log if s["gap_s"] is not None]
    result = {
        "script": script,
        "backbone": cfg.backbone.name,
        "use_checkpoint": cfg.backbone.use_checkpoint,
        "remat_encoder": cfg.transformer.remat_encoder,
        "remat_save_names": list(cfg.transformer.remat_save_names),
        "micro_batches_a_step": micro,
        "step_p50_ms": 1000 * float(np.median(steady)),
        "img_per_s": BATCH * micro * len(steady) / sum(steady),
        "warmup_ms": 1000 * steps_log[0]["s"],
        "step_ms": [1000 * s["s"] for s in steps_log],
        "gap_between_steps_ms": [1000 * g for g in gaps],
        "peak_mem_gb": peak_gb,
        "wall_s": wall,
        "launches_per_step": per_step[0],
        "launches_per_eval_forward": evals[0] if evaluate else None,
        "launches": launches,
        "window_backward_calls_per_micro_batch": launches["window_bwd"] / (n_steps * micro),
        "designs": designs,
        "checkpoint_gb": ckpt_b.stat().st_size / 1e9,
        "buckets": [s["buckets"] for s in steps_log],
        "losses": [s["loss"] for s in steps_log],
        "grad_norms": [s["grad_norm"] for s in steps_log],
        "saved": saved_a,
        "resumed": resumed_b,
        "groups_moved": moved,
        "stats": stats,
    }
    tmp.cleanup()
    log(f"[{tag}] {json.dumps(result)}")
    return result


def script_model_class(script: str) -> str:
    """The name of the class `models/factory.py` builds for the
    tools/main_path.py fine-tune `script`: its --variant's, else its
    preset's."""
    from rlipv2_tpu_torch.config import PRESETS
    from rlipv2_tpu_torch.models.factory import MODEL_CLASSES
    from rlipv2_tpu_torch.tools.main_path import FINETUNE_SCRIPTS

    preset, _, flags = FINETUNE_SCRIPTS[script]
    variant = flags[flags.index("--variant") + 1] if "--variant" in flags else PRESETS[preset]().variant
    return MODEL_CLASSES[variant].__name__


def downstream_phase(tag: str, shared: str) -> dict:
    """Phases 11, 12a and 13a-c: `rlipv2_tpu_torch.cli.main` running an R50
    fine-tune (DOWNSTREAM_SCRIPTS: scripts/finetune_vcoco_parseda_r50.sh,
    scripts/finetune_oisgg_parseda_r50.sh; PARSED_SCRIPTS:
    scripts/finetune_hico_parsed_r50.sh; RLIPV1_SCRIPTS: that command with
    --variant) on its tree over the JPEG fixture
    (`tools/main_path.py::main_finetune_tree`, the parts in `shared`
    linked, the others written there): steps[0] steps, a
    checkpoint and an evaluation of the 16 val images, then --resume for
    steps[1] and another evaluation. Every step must launch the MSDA
    forward and backward kernels 12 times each on their D = 32 designs
    (none on the dense ParSe models), every evaluation forward the forward
    kernel as often; no window or int8 launch. The resumed run restores the
    step, the learning rates and the random states; the slots are the
    script's; every stat is finite. On RLIPV1_SCRIPTS the last step runs
    under torch.profiler, which gives its busy share (device time over the
    step's wall time, the profiler's overhead in the wall)."""
    import tempfile
    from pathlib import Path

    from rlipv2_tpu_torch import cli
    from rlipv2_tpu_torch.engine import loops
    from rlipv2_tpu_torch.ops.ms_deform_attn import ms_deform_attn
    from rlipv2_tpu_torch.ops.window_attention import window_attention
    from rlipv2_tpu_torch.tools.main_path import BATCH, main_finetune_tree

    script, evaluation, slots, headline = {**DOWNSTREAM_SCRIPTS, **PARSED_SCRIPTS, **RLIPV1_SCRIPTS}[tag]
    want_model = script_model_class(script)
    want_dims = REFERENCE_DIMS[want_model]
    msda = sum(want_dims.values())
    steps = DOWNSTREAM_STEPS
    profile_at = sum(steps) - 1 if tag in RLIPV1_SCRIPTS else None
    busy = {}
    tmp = tempfile.TemporaryDirectory(prefix=f"{tag}_")
    root = Path(tmp.name)
    t0 = time.perf_counter()
    flags, _ = main_finetune_tree(root, DOWNSTREAM_TRAIN_IMAGES, DOWNSTREAM_VAL_IMAGES, script, shared=shared)
    log(f"[{tag}] tree, tokenizer and pretrained.pth written in {time.perf_counter() - t0:.1f} s")
    common = flags + ["--num_workers", "2", "--lr_drop", "1", "--output_dir"]
    steps_log, evals, eval_s = [], [], []

    def counts():
        return {"msda_fwd": ms_deform_attn.launches, "msda_bwd": ms_deform_attn.backward_launches,
                "window": window_attention.launches, "msda_int8": ms_deform_attn.int8_launches}

    def instrumented(step_fn, *args, **kwargs):
        def step(batch):
            before = counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            gap = t - step.end if step.end is not None else None
            dims_before = dict(ref_dims)
            if len(steps_log) == profile_at:
                metrics, busy["device_ms"], busy["wall_ms"] = _profiled(step_fn, batch)
            else:
                metrics = step_fn(batch)
            torch.cuda.synchronize()
            step.end = time.perf_counter()
            steps_log.append({"s": step.end - t, "gap_s": gap, **{k: v - before[k] for k, v in counts().items()},
                              "ref_dims": {d: n - dims_before.get(d, 0) for d, n in ref_dims.items()},
                              "bucket": list(batch.pixels.shape[1:3]),
                              **{k: float(metrics[k]) for k in ("loss", "grad_norm", "nonfinite")}})
            if batch.token_ids is None:
                raise AssertionError(f"[{tag}] the step got no slot tokens: the text encoder is not in the graph")
            return metrics

        step.ema_params, step.generator, step.end = step_fn.ema_params, step_fn.generator, None
        return train_one_epoch(step, *args, **kwargs)

    def counted_apply(m, *a):
        before = counts()
        out = m(*a)
        evals.append({k: v - before[k] for k, v in counts().items()})
        return out

    train_one_epoch, evaluate = loops.train_one_epoch, getattr(loops, evaluation)

    def evaluate_counted(apply_fn, *args, **kwargs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        stats = evaluate(counted_apply, *args, **kwargs)
        eval_s.append(time.perf_counter() - t)
        return stats

    torch.cuda.reset_peak_memory_stats()
    ms_deform_attn.launches = ms_deform_attn.backward_launches = ms_deform_attn.int8_launches = 0
    window_attention.launches = window_attention.backward_calls = 0
    _zero_msda_designs()
    loops.train_one_epoch = instrumented
    setattr(loops, evaluation, evaluate_counted)
    t0 = time.perf_counter()
    try:
        with _reference_dims() as ref_dims:
            run_a = cli.main(common + [str(root / "a"), "--epochs", "1", "--max_steps", str(steps[0])])
            model_class = type(run_a.state.model).__name__
            cfg, stats_a = run_a.state.model.cfg, run_a.stats
            saved_a = {"step": run_a.state.lr_scheduler.last_epoch,
                       "lr": {g["name"]: g["lr"] for g in run_a.state.optimizer.param_groups}}
            del run_a
            run_b = cli.main(common + [str(root / "b"), "--resume", str(root / "a" / "ckpt"),
                                       "--epochs", "2", "--max_steps", str(steps[1])])
            resumed_b, last_b, rng_b = run_b.resumed, run_b.state.lr_scheduler.last_epoch, run_b.state.rng_restored
            stats, ckpt_b = run_b.stats, run_b.checkpoints[-1]
            del run_b
    finally:
        loops.train_one_epoch = train_one_epoch
        setattr(loops, evaluation, evaluate)
    wall = time.perf_counter() - t0
    launches = counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    designs = _check_designs(tag, launches["msda_fwd"], {}, msda_bwd=launches["msda_bwd"])

    n_steps = sum(steps)
    want_step = {"msda_fwd": msda, "msda_bwd": msda, "window": 0, "msda_int8": 0}
    per_step = [{k: s[k] for k in want_step} for s in steps_log]
    if len(steps_log) != n_steps or per_step != [want_step] * n_steps:
        raise AssertionError(f"[{tag}] launches per step {per_step}, expected {want_step} x {n_steps}")
    want_eval = {"msda_fwd": msda, "msda_bwd": 0, "window": 0, "msda_int8": 0}
    if len(eval_s) != 2 or not evals or any(e != want_eval for e in evals):
        raise AssertionError(f"[{tag}] {len(eval_s)} evaluations, launches per forward {evals}, "
                             f"expected {want_eval}")
    total = {k: v * n_steps + sum(e[k] for e in evals) for k, v in want_step.items()}
    if launches != total:
        raise AssertionError(f"[{tag}] launches {launches}, expected {total}")
    if any(s["nonfinite"] != 0.0 or not (math.isfinite(s["loss"]) and math.isfinite(s["grad_norm"]))
           for s in steps_log):
        raise AssertionError(f"[{tag}] a step skipped its update or lost its loss: {steps_log}")
    if (cfg.max_obj_texts, cfg.max_verb_texts) != slots:
        raise AssertionError(f"[{tag}] text slots {(cfg.max_obj_texts, cfg.max_verb_texts)}, expected {slots}")
    if model_class != want_model or any(
            {d: n for d, n in s["ref_dims"].items() if n} != want_dims for s in steps_log):
        raise AssertionError(f"[{tag}] model {model_class}, reference-point dims per step "
                             f"{[s['ref_dims'] for s in steps_log]}, expected {want_dims}")
    if resumed_b != {"epoch": 0, **saved_a} or last_b != saved_a["step"] + steps[1] or rng_b is not True:
        raise AssertionError(f"[{tag}] resumed at {resumed_b} after saving {saved_a}, random states restored "
                             f"{rng_b}; step {last_b} at the end")
    for name, run_stats in (("first run", stats_a), ("resumed run", stats)):
        missing = [k for k in headline if k not in run_stats]
        bad = {k: v for k, v in run_stats.items() if not (math.isfinite(v) and 0.0 <= v <= 1.0)}
        if missing or bad:
            raise AssertionError(f"[{tag}] {name}: stats missing {missing}, out of [0, 1] {bad}")
    # each run's first step is warm-up (a new model and optimizer); the
    # profiled step is left out too
    steady = [s for i, s in enumerate(steps_log) if i not in (0, steps[0], profile_at)]
    landscape_bucket = [s["s"] for s in steady if s["bucket"] == [832, 1344]]
    gaps = [s["gap_s"] for s in steps_log if s["gap_s"] is not None]
    steady = [s["s"] for s in steady]
    result = {
        "script": script,
        "model": model_class,
        "reference_dims_per_step": want_dims,
        "text_slots": {"obj": cfg.max_obj_texts, "verb": cfg.max_verb_texts},
        "step_p50_ms": 1000 * float(np.median(steady)),
        "step_p50_ms_832x1344": 1000 * float(np.median(landscape_bucket)) if landscape_bucket else None,
        "img_per_s": BATCH * len(steady) / sum(steady),
        "warmup_ms": [1000 * steps_log[i]["s"] for i in (0, steps[0])],
        "step_ms": [1000 * s["s"] for s in steps_log],
        "gap_between_steps_ms": [1000 * g for g in gaps],
        "peak_mem_gb": peak_gb,
        "wall_s": wall,
        "eval_wall_s": eval_s,
        "eval_images": DOWNSTREAM_VAL_IMAGES,
        "launches_per_step": per_step[0],
        "launches_per_eval_forward": evals[0],
        "launches": launches,
        "designs": designs,
        "checkpoint_gb": ckpt_b.stat().st_size / 1e9,
        **({"profiled_step": {**busy, "busy_share": busy["device_ms"] / busy["wall_ms"],
                              "bucket": steps_log[profile_at]["bucket"]}} if busy else {}),
        "buckets": [s["bucket"] for s in steps_log],
        "losses": [s["loss"] for s in steps_log],
        "grad_norms": [s["grad_norm"] for s in steps_log],
        "saved": saved_a,
        "resumed": resumed_b,
        "random_states_restored": rng_b,
        "stats": {k: float(stats[k]) for k in headline},
        "stats_first_run": {k: float(stats_a[k]) for k in headline},
    }
    tmp.cleanup()
    log(f"[{tag}] {json.dumps(result)}")
    return result


def heads_phase(tree: str, finetune_p50_ms: float) -> dict:
    """Phase 14: `cli.main` with RLIP-ParSeDA's loss and head options on
    phase 8's HICO tree and pretrained.pth, which lacks the curing and
    recon heads (they keep their seeded values). 14a `finetune_hico_heads`
    (--verb_curing --masked_entity_modeling --exponential_loss
    --obj_loss_type focal --verb_loss_type asymmetric_bce): 4 steps, a
    checkpoint and an evaluation, --resume for 2 and an evaluation, then
    --eval --eval_uniformity of the checkpoint; 14b
    `finetune_hico_matching` (the same with cross_modal_matching for both
    losses): 4 steps and an evaluation, in which the curing heads take no
    gradient. Every step launches the MSDA kernels 12 + 12 times on their
    D = 32 designs, every evaluation forward 12 and returns the curing score
    that the evaluation multiplies in; each run's last step is profiled.
    14c: `criterion_phase` on the first 14a batch's outputs."""
    from pathlib import Path

    from rlipv2_tpu_torch import cli
    from rlipv2_tpu_torch.engine import loops
    from rlipv2_tpu_torch.losses.criterion import SetCriterionHOI
    from rlipv2_tpu_torch.tools.main_path import BATCH, finetune_flags

    root = Path(tree)
    captured, results, curing_grad = {}, {}, []
    criterion_call = SetCriterionHOI.__call__

    def capture(self, outputs, targets, obj_valid, verb_valid, target_verb_sim=None):
        if not captured:  # the first 14a step's outputs, targets, slots and pseudo-verb targets
            captured.update(outputs=_tree_map(lambda t: t.detach().clone(), outputs), targets=targets,
                            obj_valid=obj_valid, verb_valid=verb_valid, target_verb_sim=target_verb_sim)
        score = outputs.get("curing_score")
        if score is not None and score.requires_grad:  # fires only where the loss's graph holds the score
            score.register_hook(lambda g: curing_grad.append(float(g.float().abs().max())))
        return criterion_call(self, outputs, targets, obj_valid, verb_valid, target_verb_sim)

    train_one_epoch, evaluate_hoi = loops.train_one_epoch, loops.evaluate_hoi
    evaluate_uniformity = loops.evaluate_hoi_matching_uniformity
    for tag, (steps, uniformity) in HEADS_SCRIPTS.items():
        steps_log, evals, busy = [], [], []
        curing_grad.clear()
        profile_at = {steps[0] - 1, sum(steps) - 1}  # each run's last step

        def instrumented(step_fn, *args, **kwargs):
            def step(batch):
                before = _counts()
                torch.cuda.synchronize()
                t = time.perf_counter()
                if len(steps_log) in profile_at:
                    metrics, device_ms, wall_ms = _profiled(step_fn, batch)
                    busy.append({"device_ms": device_ms, "wall_ms": wall_ms, "busy_share": device_ms / wall_ms,
                                 "bucket": list(batch.pixels.shape[1:3])})
                else:
                    metrics = step_fn(batch)
                torch.cuda.synchronize()
                steps_log.append({"s": time.perf_counter() - t, **{k: v - before[k] for k, v in _counts().items()},
                                  "bucket": list(batch.pixels.shape[1:3]),
                                  **{k: float(metrics[k]) for k in ("loss", "grad_norm", "nonfinite")}})
                return metrics

            step.ema_params, step.generator = step_fn.ema_params, step_fn.generator
            return train_one_epoch(step, *args, **kwargs)

        def counted_apply(m, *a):
            before = _counts()
            out = m(*a)
            evals.append({**{k: v - before[k] for k, v in _counts().items()}, "cured": "curing_score" in out})
            return out

        def evaluate(apply_fn, *args, **kwargs):
            return evaluate_hoi(counted_apply, *args, **kwargs)

        def evaluate_counted_uniformity(apply_fn, *args, **kwargs):
            return evaluate_uniformity(counted_apply, *args, **kwargs)

        common = finetune_flags(root, tag) + ["--num_workers", "2", "--lr_drop", "1", "--output_dir"]
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        loops.train_one_epoch, loops.evaluate_hoi = instrumented, evaluate
        loops.evaluate_hoi_matching_uniformity = evaluate_counted_uniformity
        SetCriterionHOI.__call__ = capture
        t0 = time.perf_counter()
        try:
            run_a = cli.main(common + [str(root / tag / "a"), "--epochs", "1", "--max_steps", str(steps[0])])
            cfg, stats = run_a.state.model.cfg, [run_a.stats]
            optimizer = run_a.state.optimizer
            stepped = {k for k, p in run_a.state.model.named_parameters() if optimizer.state.get(p)}
            saved = {"step": run_a.state.lr_scheduler.last_epoch, "lr": {g["name"]: g["lr"] for g in optimizer.param_groups}}
            del run_a, optimizer
            resumed = analysis = npz_mb = None
            if steps[1]:
                run_b = cli.main(common + [str(root / tag / "b"), "--resume", str(root / tag / "a" / "ckpt"),
                                           "--epochs", "2", "--max_steps", str(steps[1])])
                resumed = {**run_b.resumed, "random_states_restored": run_b.state.rng_restored,
                           "last_step": run_b.state.lr_scheduler.last_epoch}
                stats.append(run_b.stats)
                del run_b
            if uniformity:
                run_c = cli.main(common + [str(root / tag / "c"), "--resume", str(root / tag / "b" / "ckpt"),
                                           "--eval", "--eval_uniformity"])
                stats.append(run_c.stats)
                analysis = run_c.analysis
                npz_mb = (root / tag / "c" / cli.UNIFORMITY_FILE).stat().st_size / 1e6
                del run_c
        finally:
            loops.train_one_epoch, loops.evaluate_hoi = train_one_epoch, evaluate_hoi
            loops.evaluate_hoi_matching_uniformity = evaluate_uniformity
            SetCriterionHOI.__call__ = criterion_call
        wall = time.perf_counter() - t0
        launches = _counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        designs = _check_designs(tag, launches["msda_fwd"], {}, msda_bwd=launches["msda_bwd"])

        n_steps = sum(steps)
        want_step = {"msda_fwd": MSDA_PER_FORWARD, "msda_bwd": MSDA_PER_FORWARD, "window": 0, "msda_int8": 0}
        per_step = [{k: s_[k] for k in want_step} for s_ in steps_log]
        if len(steps_log) != n_steps or per_step != [want_step] * n_steps:
            raise AssertionError(f"[{tag}] launches per step {per_step}, expected {want_step} x {n_steps}")
        want_eval = {"msda_fwd": MSDA_PER_FORWARD, "msda_bwd": 0, "window": 0, "msda_int8": 0, "cured": True}
        if not evals or any(e != want_eval for e in evals):
            raise AssertionError(f"[{tag}] evaluation forwards {evals}, expected {want_eval} each")
        if any(s_["nonfinite"] != 0.0 or not (math.isfinite(s_["loss"]) and math.isfinite(s_["grad_norm"]))
               for s_ in steps_log):
            raise AssertionError(f"[{tag}] a step skipped its update or lost its loss: {steps_log}")
        if not (cfg.verb_curing and cfg.masked_entity_modeling and cfg.subject_class):
            raise AssertionError(f"[{tag}] the model lacks the curing or recon heads or the subject head")
        recon_stepped = sorted(k for k in stepped if k.startswith("recon_"))
        if len(recon_stepped) != 14:
            raise AssertionError(f"[{tag}] recon heads the optimizer stepped: {recon_stepped}")
        # the contrastive verb loss leaves the curing score out of the graph; the BCE forms take it every step
        if len(curing_grad) != (0 if tag == "finetune_hico_matching" else n_steps):
            raise AssertionError(f"[{tag}] the curing score's gradient was read in {len(curing_grad)} of "
                                 f"{n_steps} steps")
        if resumed is not None and (resumed["epoch"], resumed["step"], resumed["lr"], resumed["random_states_restored"],
                                    resumed["last_step"]) != (0, saved["step"], saved["lr"], True,
                                                              saved["step"] + steps[1]):
            raise AssertionError(f"[{tag}] resumed {resumed} after saving {saved}")
        for run_stats in stats:
            bad = {k: v for k, v in run_stats.items() if not (math.isfinite(v) and 0.0 <= v <= 1.0)}
            if "mAP" not in run_stats or bad:
                raise AssertionError(f"[{tag}] HICO stats {run_stats}")
        if uniformity and not (analysis["n_features"] > 1 and math.isfinite(analysis["uniformity"])
                               and math.isfinite(analysis["alignment"]) and npz_mb > 0):
            raise AssertionError(f"[{tag}] uniformity analysis {analysis}, npz {npz_mb} MB")
        # each run's first step is warm-up (a new model and optimizer); the profiled steps are left out
        steady = [s_["s"] for i, s_ in enumerate(steps_log) if i not in (0, steps[0]) and i not in profile_at]
        results[tag] = {
            "script": tag,
            "step_p50_ms": 1000 * float(np.median(steady)),
            "finetune_hico_step_p50_ms": finetune_p50_ms,
            "step_p50_vs_finetune_hico": 1000 * float(np.median(steady)) / finetune_p50_ms,
            "step_ms": [1000 * s_["s"] for s_ in steps_log],
            "buckets": [s_["bucket"] for s_ in steps_log],
            "profiled_steps": busy,
            "peak_mem_gb": peak_gb,
            "wall_s": wall,
            "launches_per_step": per_step[0],
            "eval_forwards": len(evals),
            "launches": launches,
            "designs": designs,
            "losses": [s_["loss"] for s_ in steps_log],
            "grad_norms": [s_["grad_norm"] for s_ in steps_log],
            "curing_score_grad_max": list(curing_grad),
            "saved": saved,
            "resumed": resumed,
            "stats": stats,
            "uniformity": analysis,
            "uniformity_npz_mb": npz_mb,
        }
        log(f"[{tag}] {json.dumps(results[tag])}")
        gc.collect()
        torch.cuda.empty_cache()
    results["criterion"] = criterion_phase(captured)
    return results


def _tree_map(fn, tree):
    """fn on every tensor of a tree of dicts, lists and tuples (model outputs)."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _tree_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _tree_leaves(v, f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _tree_leaves(v, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


def _grad_leaves(tree):
    """The tree with every floating tensor a float32 leaf that takes a
    gradient (masks as they are)."""
    return _tree_map(lambda t: t.float().detach().clone().requires_grad_() if t.is_floating_point() else t, tree)


def _card_against_cpu(run, name: str) -> dict:
    """run(device) -> (loss terms {name: float}, total, {output leaf:
    gradient or None}) on "cuda" and "cpu": the largest relative difference
    of any term or the total, and of any output's gradient against its own
    largest |grad| on the CPU, or the case's largest where its own is zero,
    so that a card gradient that should be zero is held too."""
    (card, card_total, card_grads), (host, host_total, host_grads) = run("cuda"), run("cpu")
    if set(card) != set(host) or not all(math.isfinite(v) for v in host.values()):
        raise AssertionError(f"[criterion] {name}: terms {sorted(card)} against {sorted(host)}")
    loss_rel = max(abs(a - b) / max(abs(b), 1e-6) for a, b in
                   [(card[k], v) for k, v in host.items()] + [(card_total, host_total)])
    if set(host_grads) != set(card_grads) or any((g is None) != (card_grads[k] is None)
                                                 for k, g in host_grads.items()):
        raise AssertionError(f"[criterion] {name}: an output has a gradient on one device only")
    grads = {k: (g, card_grads[k]) for k, g in host_grads.items() if g is not None}
    case_max = max(float(g.abs().max()) for g, _ in grads.values())
    grad_rel = max(float((c - g).abs().max()) / (float(g.abs().max()) or case_max) for g, c in grads.values())
    return {"max_rel_loss": loss_rel, "max_rel_grad": grad_rel, "total": host_total, "terms": len(host),
            "grads": grads}


def criterion_phase(captured: dict) -> dict:
    """Phase 14c: SetCriterionHOI on the card against the CPU, float32, on
    one 14a batch's outputs (the heads' too), targets and pseudo-verb
    targets, for each of CRITERION_CASES with pseudo verbs, the subject
    head and the exponential decay: every loss term and the gradient of
    the weighted total with respect to every output, each against its own
    largest |grad| or, where the CPU's is all zero, the case's largest, so
    that a card gradient that should be zero is held too. Both take the
    CPU's matching, so that a near-tie assigned apart cannot hide or fake a
    difference. A case without RPL must give the curing score a nonzero
    gradient on the CPU (its BCE form then sees positives), but for plain
    bce, which takes no curing. Fails above CRITERION_REL_TOL."""
    from rlipv2_tpu_torch.config import LossConfig
    from rlipv2_tpu_torch.losses.criterion import SetCriterionHOI

    def on(device):
        return {"outputs": _tree_map(lambda t: t.to(device), captured["outputs"]),
                "targets": type(captured["targets"])(*(t.to(device) for t in captured["targets"])),
                **{k: None if captured[k] is None else captured[k].to(device)
                   for k in ("obj_valid", "verb_valid", "target_verb_sim")}}

    inputs = {"cuda": on("cuda"), "cpu": on("cpu")}
    cpu = inputs["cpu"]
    matches = SetCriterionHOI(LossConfig(), subject_class=True).match(
        [cpu["outputs"], *cpu["outputs"]["aux_outputs"]], cpu["targets"], cpu["verb_valid"])[0]

    def run(cfg, device):
        x = inputs[device]
        crit = SetCriterionHOI(cfg, subject_class=True, pseudo_verb=True)
        own_match = crit.match

        def same_matching(layers, targets, verb_valid):
            _, giou, valid = own_match(layers, targets, verb_valid)
            return matches.to(giou.device), giou, valid

        crit.match = same_matching
        outputs = _grad_leaves(x["outputs"])
        losses = crit(outputs, x["targets"], x["obj_valid"], x["verb_valid"], x["target_verb_sim"])
        total = crit.weighted_total(losses)
        total.backward()
        return ({k: float(v.detach()) for k, v in losses.items() if k.startswith("loss_")}, float(total.detach()),
                {k: None if t.grad is None else t.grad.cpu() for k, t in _tree_leaves(outputs)})

    cases, worst = {}, {"loss": 0.0, "grad": 0.0}
    t0 = time.perf_counter()
    for verb, obj, rpl in CRITERION_CASES:
        name = f"{verb}/{obj}" + ("" if rpl else "/no_rpl")
        cfg = LossConfig(giou_verb_label=rpl, exponential_loss=True, verb_loss_type=verb, obj_loss_type=obj)
        case = _card_against_cpu(functools.partial(run, cfg), name)
        grads = case.pop("grads")
        curing_max = float(grads["curing_score"][0].abs().max()) if "curing_score" in grads else 0.0
        if not rpl and verb != "bce" and curing_max == 0.0:
            raise AssertionError(f"[criterion] {name}: the curing score took no gradient without RPL")
        cases[name] = {**case, "curing_grad_max": curing_max}
        worst = {"loss": max(worst["loss"], case["max_rel_loss"]), "grad": max(worst["grad"], case["max_rel_grad"])}
    result = {"max_rel_diff": max(worst.values()), "max_rel_loss": worst["loss"], "max_rel_grad": worst["grad"],
              "tolerance": CRITERION_REL_TOL, "seconds": time.perf_counter() - t0, "cases": cases}
    log(f"[criterion] {json.dumps(result)}")
    if result["max_rel_diff"] > CRITERION_REL_TOL:
        raise AssertionError(f"[criterion] card against CPU {result['max_rel_diff']} > {CRITERION_REL_TOL}")
    return result


def _profiled(step_fn, batch):
    """(step_fn(batch), device ms, wall ms) of one step under torch.profiler
    (the CUDA activity): the device time summed over its kernels, the wall
    time on the host clock to the step's synchronize."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        metrics = step_fn(batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    device_us = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    if device_us <= 0:
        raise AssertionError("the profiler saw no device time in the step")
    return metrics, device_us / 1e3, 1e3 * wall


@contextlib.contextmanager
def _reference_dims():
    """Counts the MSDA modules' calls inside the block by the last dim of
    their reference points: 2 (points) or 4 (DAB anchors)."""
    from rlipv2_tpu_torch.models.layers import MSDeformAttention

    forward, seen = MSDeformAttention.forward, {}

    def counted(self, query, reference_points, *a, **k):
        d = int(reference_points.shape[-1])
        seen[d] = seen.get(d, 0) + 1
        return forward(self, query, reference_points, *a, **k)

    MSDeformAttention.forward = counted
    try:
        yield seen
    finally:
        MSDeformAttention.forward = forward


@contextlib.contextmanager
def _tagger_forwards():
    """Records every `forward_tagger` call inside the block: its rows, its
    MSDA launches, its time on the host clock (synchronized), and whether
    its attended pair slots are exactly the targets' valid ones, with slot
    0 of an empty image, and its (box, label) noise scales."""
    from rlipv2_tpu_torch.models.parseda import RLIPParSeDA
    from rlipv2_tpu_torch.ops.ms_deform_attn import ms_deform_attn

    forward, calls = RLIPParSeDA.forward_tagger, []

    def recorded(self, pixels, pixel_valid, text_emb, text_valid, targets, n_obj_texts, box_noise_scale,
                 label_noise_scale, generator=None):
        before = (ms_deform_attn.launches, ms_deform_attn.backward_launches)
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = forward(self, pixels, pixel_valid, text_emb, text_valid, targets, n_obj_texts, box_noise_scale,
                      label_noise_scale, generator)
        torch.cuda.synchronize()
        valid = targets.valid
        first = torch.arange(valid.shape[1], device=valid.device) == 0
        want = valid | (~valid.any(dim=1, keepdim=True) & first)
        calls.append({"s": time.perf_counter() - t, "rows": int(pixels.shape[0]),
                      "fwd": ms_deform_attn.launches - before[0], "bwd": ms_deform_attn.backward_launches - before[1],
                      "slots_as_targets": bool(torch.equal(out["tagger_slot_valid"], want)),
                      "valid_pairs": int(valid.sum()), "pair_slots": int(valid.numel()),
                      "noise": (box_noise_scale, label_noise_scale)})
        return out

    RLIPParSeDA.forward_tagger = recorded
    try:
        yield calls
    finally:
        RLIPParSeDA.forward_tagger = forward


def _zero_counts() -> None:
    from rlipv2_tpu_torch.ops.ms_deform_attn import ms_deform_attn
    from rlipv2_tpu_torch.ops.window_attention import window_attention

    ms_deform_attn.launches = ms_deform_attn.backward_launches = ms_deform_attn.int8_launches = 0
    window_attention.launches = window_attention.backward_calls = 0
    _zero_msda_designs()


def _counts() -> dict:
    from rlipv2_tpu_torch.ops.ms_deform_attn import ms_deform_attn
    from rlipv2_tpu_torch.ops.window_attention import window_attention

    return {"msda_fwd": ms_deform_attn.launches, "msda_bwd": ms_deform_attn.backward_launches,
            "window": window_attention.launches, "msda_int8": ms_deform_attn.int8_launches}


def tagger_train_phase():
    """Phase 12b: `cli.main` running scripts/tagger_train_vg.sh (RLIP-ParSeD
    with its tagger parameters, warm-started from a RLIP-ParSeD
    pretrained.pth; noised GT pairs through the DAB decoders; BCE verb
    loss) on the VG file of phase 9's tree: TAGGER_STEPS[0] steps and a
    checkpoint, then --resume for TAGGER_STEPS[1]. Returns (result, the
    temporary directory, which 12c reads and then removes, and the last
    checkpoint of the first run)."""
    import tempfile
    from pathlib import Path

    from rlipv2_tpu_torch import cli
    from rlipv2_tpu_torch.engine import loops
    from rlipv2_tpu_torch.tools.main_path import BATCH, main_pretrain_tree

    tag = "tagger_train_vg"
    tmp = tempfile.TemporaryDirectory(prefix="tagger_")
    root = Path(tmp.name)
    t0 = time.perf_counter()
    flags, _, tree = main_pretrain_tree(root, tag)
    log(f"[{tag}] VG tree, tokenizer and pretrained.pth written in {time.perf_counter() - t0:.1f} s")
    common = flags + ["--num_workers", "2", "--lr_drop", "1", "--output_dir"]
    steps_log, starts = [], []

    def instrumented(step_fn, model, dataset, *args, **kwargs):
        """`train_one_epoch` with each step timed and its launches counted,
        and the random states the run starts from (before the loader
        draws) kept."""
        starts.append({"generator": step_fn.generator.get_state().clone(), "sampler": dataset.pair_rng.getstate(),
                       "max_triplets": kwargs.get("max_triplets")})

        def step(batch):
            before = _counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            gap = t - step.end if step.end is not None else None
            metrics = step_fn(batch)
            torch.cuda.synchronize()
            step.end = time.perf_counter()
            steps_log.append({"s": step.end - t, "gap_s": gap, **{k: v - before[k] for k, v in _counts().items()},
                              "bucket": list(batch.pixels.shape[1:3]), "text_slots": int(batch.text_valid.shape[1]),
                              **{k: float(metrics[k]) for k in ("loss", "grad_norm", "nonfinite")}})
            if batch.token_ids is None:
                raise AssertionError(f"[{tag}] the step got no slot tokens: the text encoder is not in the graph")
            return metrics

        step.ema_params, step.generator, step.end = step_fn.ema_params, step_fn.generator, None
        return train_one_epoch(step, model, dataset, *args, **kwargs)

    train_one_epoch = loops.train_one_epoch
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    loops.train_one_epoch = instrumented
    t0 = time.perf_counter()
    try:
        with _tagger_forwards() as forwards:
            run_a = cli.main(common + [str(root / "a"), "--epochs", "1", "--max_steps", str(TAGGER_STEPS[0])])
            model = run_a.state.model
            model_class, cfg = type(model).__name__, model.cfg
            tagger = (model.tagger, cfg.subject_class, cfg.num_queries)
            saved_a = {"step": run_a.state.lr_scheduler.last_epoch,
                       "lr": {g["name"]: g["lr"] for g in run_a.state.optimizer.param_groups}}
            end_a = {"generator": run_a.state.generator.get_state().clone(),
                     "sampler": run_a.state.sampler_rng.getstate()}
            ckpt = run_a.checkpoints[-1]
            del run_a, model
            run_b = cli.main(common + [str(root / "b"), "--resume", str(root / "a" / "ckpt"),
                                       "--epochs", "2", "--max_steps", str(TAGGER_STEPS[1])])
            resumed_b, last_b, rng_b = run_b.resumed, run_b.state.lr_scheduler.last_epoch, run_b.state.rng_restored
            del run_b
    finally:
        loops.train_one_epoch = train_one_epoch
    wall = time.perf_counter() - t0
    launches = _counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    designs = _check_designs(tag, launches["msda_fwd"], {}, msda_bwd=launches["msda_bwd"])

    n_steps = sum(TAGGER_STEPS)
    want_step = {"msda_fwd": MSDA_PER_FORWARD, "msda_bwd": MSDA_PER_FORWARD, "window": 0, "msda_int8": 0}
    per_step = [{k: s[k] for k in want_step} for s in steps_log]
    if len(steps_log) != n_steps or per_step != [want_step] * n_steps or launches != {
            k: v * n_steps for k, v in want_step.items()}:
        raise AssertionError(f"[{tag}] launches per step {per_step}, in all {launches}, expected {want_step} x {n_steps}")
    if model_class != "RLIPParSeD" or tagger != (True, True, cfg.num_queries):
        raise AssertionError(f"[{tag}] model {model_class}, (tagger, subject_class, queries) {tagger}")
    M = cfg.num_queries // 2
    if (len(forwards) != n_steps or not all(f["slots_as_targets"] and f["noise"] == (0.6, 0.3) for f in forwards)
            or any(f["pair_slots"] != BATCH * M for f in forwards) or starts[0]["max_triplets"] != M):
        raise AssertionError(f"[{tag}] tagger forwards {forwards}, pair slots a batch {BATCH} x {M}")
    if any(s["nonfinite"] != 0.0 or not (math.isfinite(s["loss"]) and math.isfinite(s["grad_norm"]))
           for s in steps_log):
        raise AssertionError(f"[{tag}] a step skipped its update or lost its loss: {steps_log}")
    saved_rng = torch.load(ckpt, map_location="cpu", weights_only=True)["rng"]
    restored = (len(starts) == 2 and torch.equal(starts[1]["generator"], end_a["generator"])
                and starts[1]["sampler"] == end_a["sampler"] and torch.equal(saved_rng["step"], end_a["generator"])
                and saved_rng["sampler"] == end_a["sampler"])
    if resumed_b != {"epoch": 0, **saved_a} or last_b != saved_a["step"] + TAGGER_STEPS[1] or not (
            rng_b is True and restored):
        raise AssertionError(f"[{tag}] resumed at {resumed_b} after saving {saved_a}, step {last_b} at the end, "
                             f"random states restored {rng_b}, the noise generator and pair sampler where the "
                             f"first run left them {restored}")
    steady = [s["s"] for i, s in enumerate(steps_log) if i not in (0, TAGGER_STEPS[0])]
    gaps = [s["gap_s"] for s in steps_log if s["gap_s"] is not None]
    result = {
        "script": "scripts/tagger_train_vg.sh",
        "model": model_class,
        "text_slots": {"obj": cfg.max_obj_texts, "verb": cfg.max_verb_texts},
        "pair_slots": M,
        "valid_pairs_per_batch": [f["valid_pairs"] for f in forwards],
        "step_p50_ms": 1000 * float(np.median(steady)),
        "img_per_s": BATCH * len(steady) / sum(steady),
        "warmup_ms": [1000 * steps_log[i]["s"] for i in (0, TAGGER_STEPS[0])],
        "step_ms": [1000 * s["s"] for s in steps_log],
        "gap_between_steps_ms": [1000 * g for g in gaps],
        "peak_mem_gb": peak_gb,
        "wall_s": wall,
        "launches_per_step": per_step[0],
        "launches": launches,
        "designs": designs,
        "checkpoint_gb": ckpt.stat().st_size / 1e9,
        "buckets": [s["bucket"] for s in steps_log],
        "losses": [s["loss"] for s in steps_log],
        "grad_norms": [s["grad_norm"] for s in steps_log],
        "saved": saved_a,
        "resumed": resumed_b,
        "random_states_restored": rng_b,
        "noise_generator_and_pair_sampler_restored": restored,
    }
    log(f"[{tag}] {json.dumps(result)}")
    return result, tmp, ckpt


def tagger_generate_phase(tmp, ckpt) -> dict:
    """Phase 12c: `tools/generate_relations.py`'s command line with
    scripts/tagger_generate_coco.sh's flags on 12b's checkpoint, over a COCO
    tree of COCO_IMAGES copies of the JPEG fixture (`tools/coco_tree.py`),
    twice: at threshold 0, which writes every (pair, candidate) score, and
    at the median of those scores (at random weights the script's
    TAGGER_THRESHOLD keeps none; the run prints how many it would keep).
    Each run scores its rows TAGGER_ROWS at a time by `forward_tagger`, 12
    MSDA forward launches a forward and no backward; the second writes
    exactly the first's scores that reach its threshold, each in
    [threshold, 1], and its output is read back by `build_coco_rlip` (the VG
    reader, nvJPEG) as pre-training reads pseudo-labelled COCO."""
    from pathlib import Path

    from rlipv2_tpu_torch.data.coco import build_coco_rlip
    from rlipv2_tpu_torch.data.transforms import HOITransform
    from rlipv2_tpu_torch.tools import generate_relations
    from rlipv2_tpu_torch.tools.coco_tree import write_coco_tree
    from rlipv2_tpu_torch.tools.hico_fixture import FIXTURE_DIR, FIXTURES
    from rlipv2_tpu_torch.tools.main_path import SEED

    tag = "tagger_generate_coco"
    root = Path(tmp.name)
    coco = write_coco_tree(root / "coco", [(FIXTURE_DIR / f.name, f.height, f.width) for f in FIXTURES],
                           n_images=COCO_IMAGES, seed=SEED)
    candidates = json.loads(Path(coco["rel_candidates"]).read_text())
    rows = sum(1 for groups in candidates.values() for pairs, texts in groups if pairs and texts)
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    runs = []
    for k in range(2):
        threshold = 0.0 if k == 0 else float(np.median([r["confidence"] for a in runs[0]["annos"]
                                                         for r in a["relationships"]]))
        out = root / f"coco_pseudo_relations_{k}.json"
        argv = ["--checkpoint", str(ckpt), "--coco_img_folder", str(coco["img_folder"]),
                "--coco_ann_file", str(coco["ann_file"]), "--rel_candidates", str(coco["rel_candidates"]),
                "--relation_threshold", str(threshold), "--out", str(out)]
        before = _counts()
        t0 = time.perf_counter()
        with _tagger_forwards() as forwards:
            annos = generate_relations.main(argv)
        runs.append({"annos": annos, "forwards": forwards, "wall_s": time.perf_counter() - t0, "out": out,
                     "threshold": threshold, "launches": {k: v - before[k] for k, v in _counts().items()}})
    launches = _counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    designs = _check_designs(tag, launches["msda_fwd"], {})
    forwards = [f for r in runs for f in r["forwards"]]
    want = {"msda_fwd": MSDA_PER_FORWARD * len(forwards), "msda_bwd": 0, "window": 0, "msda_int8": 0}
    if launches != want or any((f["fwd"], f["bwd"], f["rows"], f["noise"]) != (
            MSDA_PER_FORWARD, 0, TAGGER_ROWS, (0.0, 0.0)) or not f["slots_as_targets"] for f in forwards):
        raise AssertionError(f"[{tag}] launches {launches}, expected {want}; forwards {forwards}")
    every = [r["confidence"] for a in runs[0]["annos"] for r in a["relationships"]]
    threshold = runs[1]["threshold"]
    confs = [r["confidence"] for a in runs[1]["annos"] for r in a["relationships"]]
    if (any(len(r["forwards"]) != -(-rows // TAGGER_ROWS) for r in runs) or not confs
            or len(confs) != sum(c >= threshold for c in every) or not all(threshold <= c <= 1.0 for c in confs)
            or any(json.loads(r["out"].read_text()) != r["annos"] for r in runs)):
        raise AssertionError(f"[{tag}] forwards {[len(r['forwards']) for r in runs]} for {rows} rows; "
                             f"{len(every)} scores, {len(confs)} written at {threshold}; out of [threshold, 1]: "
                             f"{[c for c in confs if not threshold <= c <= 1.0][:5]}")
    ds = build_coco_rlip(runs[1]["out"], {"coco2017": coco["coco2017_folder"]}, num_queries=200, device="cuda",
                         transforms=HOITransform(train=False))
    try:
        img, target = ds[0]
    finally:
        ds.close()
    if len(ds) == 0 or not len(target["obj_labels"]) or not (
            (target["sub_boxes"] >= 0).all() and (target["sub_boxes"][:, 2] <= img.shape[1] + 1e-3).all()):
        raise AssertionError(f"[{tag}] read back {len(ds)} images; first target {target}")
    steady = [f["s"] for r in runs for f in r["forwards"][1:]]  # each run's first forward is warm-up
    result = {
        "script": "scripts/tagger_generate_coco.sh",
        "images": len(runs[1]["annos"]),
        "rows": rows,
        "forwards_per_run": len(runs[0]["forwards"]),
        "rows_per_forward": TAGGER_ROWS,
        "scores": len(every),
        "score_range": [min(every), max(every)],
        "kept_at_script_threshold": {"threshold": TAGGER_THRESHOLD,
                                     "relationships": sum(c >= TAGGER_THRESHOLD for c in every)},
        "threshold": threshold,
        "relationships": len(confs),
        "forward_p50_ms": 1000 * float(np.median(steady)),
        "rows_per_s_forward": TAGGER_ROWS * len(steady) / sum(steady),
        "rows_per_s_wall": [rows / r["wall_s"] for r in runs],
        "warmup_ms": [1000 * r["forwards"][0]["s"] for r in runs],
        "peak_mem_gb": peak_gb,
        "wall_s": [r["wall_s"] for r in runs],
        "launches_per_forward": {"msda_fwd": MSDA_PER_FORWARD, "msda_bwd": 0, "window": 0, "msda_int8": 0},
        "launches": launches,
        "designs": designs,
        "read_back_images": len(ds),
    }
    tmp.cleanup()
    log(f"[{tag}] {json.dumps(result)}")
    return result


def _zero_msda_designs() -> None:
    from rlipv2_tpu_torch.ops.ms_deform_attn import ms_deform_attn

    for counter in (ms_deform_attn.designs, ms_deform_attn.backward_designs, ms_deform_attn.int8_designs):
        counter.update(dict.fromkeys(counter, 0))


@contextlib.contextmanager
def _window_launch_shapes():
    """Counts the window-attention kernel's launches inside the block by
    qkv dtype and tokens a window ("bfloat16/N144"): the kernel takes its
    tensor-core tiles for bf16 and its SIMT design for float32. Wraps the
    wrapper's launch function and counts each call of it."""
    module = importlib.import_module("rlipv2_tpu_torch.ops.window_attention")
    launch, seen = module._launch_kernel, {}

    def counted(qkv, bias, mask, h):
        key = f"{str(qkv.dtype).replace('torch.', '')}/N{qkv.shape[1]}"
        seen[key] = seen.get(key, 0) + 1
        return launch(qkv, bias, mask, h)

    module._launch_kernel = counted
    try:
        yield seen
    finally:
        module._launch_kernel = launch


def _check_designs(tag: str, msda_fwd: int, window_shapes: dict, msda_bwd: int = 0, msda_int8: int = 0) -> dict:
    """The designs a main path's launches took, read just after it: every
    MSDA forward launch the D = 32 gather, every backward launch the D = 32
    gather and vector scatter, every int8 launch the D = 32 int8 gather,
    every window-attention launch on bf16 windows of 144 tokens (the
    tensor-core tiles). `msda_fwd`, `msda_bwd` and `msda_int8` are the
    path's launch counts."""
    from rlipv2_tpu_torch.ops.ms_deform_attn import ms_deform_attn

    designs = {"msda_fwd": dict(ms_deform_attn.designs), "msda_bwd": dict(ms_deform_attn.backward_designs),
               "msda_int8": dict(ms_deform_attn.int8_designs), "window": dict(window_shapes)}

    def only(counter, main, n):
        return {k: n if k == main else 0 for k in counter}

    want = {"msda_fwd": only(designs["msda_fwd"], MSDA_MAIN_DESIGN, msda_fwd),
            "msda_bwd": only(designs["msda_bwd"], MSDA_BWD_MAIN_DESIGN, msda_bwd),
            "msda_int8": only(designs["msda_int8"], MSDA_INT8_MAIN_DESIGN, msda_int8),
            "window": {k: v for k, v in window_shapes.items() if k == WINDOW_MAIN_LAUNCH}}
    if designs != want:
        raise AssertionError(f"[{tag}] kernel designs {designs}, expected {want}")
    return designs


def _no_dropout(model):
    """Every dropout of `model` off (phase 17)."""
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
        elif isinstance(m, torch.nn.MultiheadAttention):
            m.dropout = 0.0
    return model


def _dp_run(argv: list) -> dict:
    """`cli.main(argv)` with every dropout off, in this process (one of
    phase 17's ranks, or its one-process runs): each step's launches,
    metrics and seconds; each evaluation forward's MSDA launches; the
    evaluation's per-image top verb score, in the evaluator's order; the
    sharded evaluation's local and deduped image ids; the data axis; the
    stats, the checkpoints written and the peak memory. Every launch count
    is set to 0 first and read after."""
    from rlipv2_tpu_torch import cli
    from rlipv2_tpu_torch.engine import loops
    from rlipv2_tpu_torch.models import factory
    from rlipv2_tpu_torch.ops.ms_deform_attn import ms_deform_attn
    from rlipv2_tpu_torch.parallel.dist_eval import DistEvalBuffer

    steps, evals, top, dedupe, axis = [], [], [], {}, {}
    saved = (factory.build_model, loops.train_one_epoch, loops.evaluate_hoi, loops._run_hico_evaluator,
             DistEvalBuffer.gather_and_dedupe, cli.distributed)
    build, train_one_epoch, evaluate_hoi, evaluator, gather_and_dedupe, distributed = saved

    def instrumented(step_fn, *args, **kwargs):
        def step(batch):
            before = (ms_deform_attn.launches, ms_deform_attn.backward_launches)
            torch.cuda.synchronize()
            t = time.perf_counter()
            metrics = step_fn(batch)
            torch.cuda.synchronize()
            steps.append({"s": time.perf_counter() - t, "fwd": ms_deform_attn.launches - before[0],
                          "bwd": ms_deform_attn.backward_launches - before[1], "images": batch.pixels.shape[0],
                          "bucket": list(batch.pixels.shape[1:3]),
                          **{k: float(metrics[k]) for k in ("loss", "grad_norm", "nonfinite")}})
            return metrics

        step.ema_params = step_fn.ema_params
        return train_one_epoch(step, *args, **kwargs)

    def counted_apply(m, *a):
        evals.append(ms_deform_attn.launches)
        out = m(*a)
        evals[-1] = ms_deform_attn.launches - evals[-1]
        return out

    def recorded(dataset, preds, gts, *a):
        top.extend(float(p["verb_scores"].max()) for p in preds)
        return evaluator(dataset, preds, gts, *a)

    def deduped(self, gather_fn=None):
        dedupe["local"] = self._local()[0].tolist()
        ids, tree = gather_and_dedupe(self, gather_fn)
        dedupe["ids"] = ids.tolist()
        return ids, tree

    def joined(args):
        mesh, own = distributed(args)
        if mesh is not None:
            axis.update(backend=mesh.backend, world=mesh.world, rank=mesh.rank)
        return mesh, own

    _zero_counts()
    torch.cuda.reset_peak_memory_stats()
    factory.build_model = lambda *a, **k: _no_dropout(build(*a, **k))
    loops.train_one_epoch, loops._run_hico_evaluator = instrumented, recorded
    loops.evaluate_hoi = lambda apply_fn, *a, **k: evaluate_hoi(counted_apply, *a, **k)
    DistEvalBuffer.gather_and_dedupe, cli.distributed = deduped, joined
    t0 = time.perf_counter()
    try:
        run = cli.main(argv)
    finally:
        (factory.build_model, loops.train_one_epoch, loops.evaluate_hoi, loops._run_hico_evaluator,
         DistEvalBuffer.gather_and_dedupe, cli.distributed) = saved
    counts = _counts()
    designs = _check_designs("dp", counts["msda_fwd"], {}, msda_bwd=counts["msda_bwd"])
    return {"steps": steps, "evals": evals, "top": top, "dedupe": dedupe, "axis": axis, "counts": counts,
            "designs": designs, "stats": run.stats, "checkpoints": [str(p) for p in run.checkpoints],
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "wall_s": time.perf_counter() - t0}


def phase17_rank(argv: list) -> None:
    """A rank of phase 17 under torchrun: `_dp_run` of the flags after
    "--", its numbers written to argv[0]/rank<RANK>.json."""
    from pathlib import Path

    if not torch.cuda.is_available():
        raise SystemExit("phase 17's rank needs a CUDA device")
    result = _dp_run(argv[argv.index("--") + 1 :])
    (Path(argv[0]) / f"rank{int(os.environ['RANK'])}.json").write_text(json.dumps(result))


def _torchrun(nproc: int, out, argv: list) -> tuple[list, float]:
    """`python -m torch.distributed.run --standalone --nproc_per_node
    nproc` of this script's `--phase17-rank out -- argv`: the ranks'
    results and the call's seconds. Its output goes to out/torchrun.log,
    whose tail a failure shows; past DP_TIMEOUT_S its whole process group
    is killed."""
    import signal
    from pathlib import Path

    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", str(nproc),
           str(Path(__file__).resolve()), "--phase17-rank", str(out), "--", *argv]
    t0 = time.perf_counter()
    with open(out / "torchrun.log", "w") as f:
        proc = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT, start_new_session=True,
                                cwd=str(Path(__file__).resolve().parent))
        try:
            code = proc.wait(timeout=DP_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
            code = "killed at the time limit"
    wall = time.perf_counter() - t0
    if code != 0:
        tail = "\n".join((out / "torchrun.log").read_text().splitlines()[-40:])
        raise AssertionError(f"[dp] torchrun --nproc_per_node {nproc}: exit {code} after {wall:.1f} s\n{tail}")
    return [json.loads((out / f"rank{r}.json").read_text()) for r in range(nproc)], wall


def _dp_check(tag: str, got: dict, world: int, rank: int, steps: int, backend: str) -> None:
    """One rank's run: its steps, launches, evaluation coverage and axis."""
    s = got["steps"]
    if len(s) != steps or any((x["fwd"], x["bwd"]) != (MSDA_PER_FORWARD,) * 2 for x in s):
        raise AssertionError(f"[{tag}] rank {rank}: launches per step {[(x['fwd'], x['bwd']) for x in s]}")
    if any(x["images"] != 8 // world or x["nonfinite"] != 0.0 or not math.isfinite(x["loss"]) for x in s):
        raise AssertionError(f"[{tag}] rank {rank}: steps {s}")
    if not got["evals"] or any(e != MSDA_PER_FORWARD for e in got["evals"]):
        raise AssertionError(f"[{tag}] rank {rank}: launches per evaluation forward {got['evals']}")
    if got["counts"]["window"] or got["counts"]["msda_int8"]:
        raise AssertionError(f"[{tag}] rank {rank}: launches {got['counts']}")
    if got["dedupe"].get("ids") != list(range(DP_VAL_IMAGES)) or len(got["top"]) != DP_VAL_IMAGES:
        raise AssertionError(f"[{tag}] rank {rank}: the evaluation's images {got['dedupe']}, {len(got['top'])} scored")
    if got["axis"] != {"backend": backend, "world": world, "rank": rank}:
        raise AssertionError(f"[{tag}] rank {rank}: data axis {got['axis']}")
    for k, v in got["stats"].items():
        if not (math.isfinite(v) and 0.0 <= v <= 1.0):
            raise AssertionError(f"[{tag}] rank {rank}: HICO stat {k} = {v}")


def dp_phase(shared: str) -> tuple[dict, dict]:
    """Phase 17: 17a, two gloo ranks on the one card, against one process;
    17b, one rank under nccl. Returns (result, launches by path)."""
    import tempfile
    from pathlib import Path

    from rlipv2_tpu_torch.tools.main_path import main_finetune_tree

    with tempfile.TemporaryDirectory(prefix="phase17_") as tmp:
        root = Path(tmp)
        flags, _ = main_finetune_tree(root, DP_TRAIN_IMAGES, DP_VAL_IMAGES, shared=shared, val_landscape=True)
        common = flags + ["--num_workers", "2", "--epochs", "1"]
        one = _dp_run(common + ["--output_dir", str(root / "one"), "--max_steps", "1"])
        gc.collect()
        torch.cuda.empty_cache()
        ranks, wall_a = _torchrun(2, root / "ranks_a", common + [
            "--dist_backend", "gloo", "--output_dir", str(root / "dp"), "--max_steps", str(DP_STEPS)])
        evaluated = _dp_run(flags + ["--output_dir", str(root / "eval"), "--resume", str(root / "dp" / "ckpt"),
                                     "--eval"])
        gc.collect()
        torch.cuda.empty_cache()
        nccl, wall_b = _torchrun(1, root / "ranks_b", common + ["--output_dir", str(root / "nccl"),
                                                                "--max_steps", "1"])
        log_lines = len((root / "dp" / "log.txt").read_text().splitlines())
        ckpt = str(root / "dp" / "ckpt" / "checkpoint0000.pth")

    for r, got in enumerate(ranks):
        _dp_check("dp_gloo", got, 2, r, DP_STEPS, "gloo")
    _dp_check("dp_nccl", nccl[0], 1, 0, 1, "nccl")
    ref = one["steps"][0]
    rel = {k: max(abs(got["steps"][0][k] - ref[k]) / abs(ref[k]) for got in ranks) for k in ("loss", "grad_norm")}
    if any(v > DP_REL_TOL for v in rel.values()):
        raise AssertionError(f"[dp_gloo] first step against one process: relative differences {rel} "
                             f"(ranks {[got['steps'][0] for got in ranks]}, one process {ref})")
    covered = sorted(set(ranks[0]["dedupe"]["local"]) | set(ranks[1]["dedupe"]["local"]))
    if covered != list(range(DP_VAL_IMAGES)):
        raise AssertionError(f"[dp_gloo] the ranks' shards cover {covered}")
    want = np.asarray(evaluated["top"])
    scale = float(np.abs(want).max())
    score_diff = max(float(np.abs(np.asarray(got["top"]) - want).max()) for got in ranks) / scale
    if len(want) != DP_VAL_IMAGES or score_diff > DP_REL_TOL:
        raise AssertionError(f"[dp_gloo] top scores {[got['top'] for got in ranks]} against one process {list(want)}")
    if ranks[0]["stats"] != ranks[1]["stats"]:
        raise AssertionError(f"[dp_gloo] the ranks' stats differ: {ranks[0]['stats']} {ranks[1]['stats']}")
    if ranks[0]["checkpoints"] != [ckpt] or ranks[1]["checkpoints"] or log_lines != 1:
        raise AssertionError(f"[dp_gloo] checkpoints {[got['checkpoints'] for got in ranks]}, "
                             f"{log_lines} log lines: rank 0 alone writes")

    def summary(got):
        return {"step_ms": [1000 * x["s"] for x in got["steps"]], "losses": [x["loss"] for x in got["steps"]],
                "grad_norms": [x["grad_norm"] for x in got["steps"]], "peak_mem_gb": got["peak_mem_gb"],
                "wall_s": got["wall_s"], "launches": got["counts"], "eval_forwards": len(got["evals"]),
                "local_eval_ids": got["dedupe"]["local"]}

    result = {
        "one_process": {"loss": ref["loss"], "grad_norm": ref["grad_norm"], "step_ms": 1000 * ref["s"],
                        "peak_mem_gb": one["peak_mem_gb"], "eval_of_17a_checkpoint_stats": evaluated["stats"]},
        "dp_gloo_2ranks": {"torchrun_wall_s": wall_a, "ranks": [summary(got) for got in ranks],
                           "first_step_rel_diff": rel, "top_score_diff_over_max": score_diff,
                           "stats": ranks[0]["stats"]},
        "dp_nccl_1rank": {"torchrun_wall_s": wall_b, **summary(nccl[0]), "stats": nccl[0]["stats"]},
    }

    def launches(runs):
        return {k: sum(got["counts"][k] for got in runs) for k in ("msda_fwd", "msda_bwd", "window", "msda_int8")}

    log(f"[dp] {json.dumps(result)}")
    return result, {"dp_gloo_2ranks": launches(ranks), "dp_nccl_1rank": launches(nccl)}


def golden_pack_phase() -> None:
    from rlipv2_tpu_torch.tools.golden_pack import check_pack

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = check_pack(device="cuda")
    log(f"[golden] max abs delta {max(report.values()):.3g} over {len(report)} outputs (limit 2e-3)")


def main_path_phase(tag: str, builder: str, per_forward_expected: dict, **builder_kwargs):
    """`evaluate_hoi` of the model that `tools/main_path.py::<builder>`
    builds; `tag` names the path in the log and the kernels line. Every
    forward must launch the kernels `per_forward_expected` gives
    (msda_fwd, msda_int8, window) and call each int8 projection of the
    model once. Returns (result, cfg, model)."""
    from rlipv2_tpu_torch.data.synthetic import SyntheticHICODataset, hash_tokenize
    from rlipv2_tpu_torch.engine.loops import CachedTextEncoder, evaluate_hoi
    from rlipv2_tpu_torch.ops.int8_dense import Int8Linear
    from rlipv2_tpu_torch.ops.ms_deform_attn import ms_deform_attn
    from rlipv2_tpu_torch.ops.window_attention import window_attention
    from rlipv2_tpu_torch.tools import main_path
    from rlipv2_tpu_torch.tools.main_path import BATCH, BUCKET

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    cfg, model = getattr(main_path, builder)(dev, **builder_kwargs)
    n_params = sum(p.numel() for p in model.parameters())
    n_int8 = sum(isinstance(m, Int8Linear) for m in model.modules())
    log(f"[{tag}] {cfg.backbone.name} model {n_params / 1e6:.1f}M params, msda_impl {cfg.transformer.msda_impl!r}, "
        f"{n_int8} int8 projections, ready in {time.perf_counter() - t0:.1f} s")
    expected = {**per_forward_expected, "int8_linear": n_int8}

    dataset = SyntheticHICODataset(BATCH * N_BATCHES, seed=0)
    # a model without a text encoder (RLIPParSeV1Joint) takes cached pooled
    # features of a seeded RoBERTa-base
    encode_text = getattr(model, "encode_text", None) or main_path.pooled_text_encoder(cfg, dev)

    def encode_fn(texts):
        ids, mask = hash_tokenize(texts, cfg.text_encoder.vocab_size, maxlen=16)
        pooled = encode_text(torch.from_numpy(ids).to(dev), torch.from_numpy(mask).to(dev))
        return pooled.cpu().numpy()

    latencies, per_forward = [], []

    def counts():
        return {"msda_fwd": ms_deform_attn.launches, "msda_int8": ms_deform_attn.int8_launches,
                "window": window_attention.launches, "int8_linear": Int8Linear.calls}

    def apply_fn(m, pixels, valid, text_emb, text_valid, n_obj):
        before = counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = m(pixels, valid, text_emb, text_valid, n_obj)
        torch.cuda.synchronize()
        latencies.append(time.perf_counter() - t)
        per_forward.append({k: v - before[k] for k, v in counts().items()})
        B = pixels.shape[0]
        if tuple(out["pred_verb_logits"].shape) != (B, cfg.num_queries // 2, cfg.max_verb_texts):
            raise AssertionError(f"verb logits shape {tuple(out['pred_verb_logits'].shape)}")
        for k in ("pred_obj_logits", "pred_verb_logits", "pred_sub_boxes", "pred_obj_boxes"):
            if not bool(torch.isfinite(out[k]).all()):
                raise AssertionError(f"non-finite {k}")
        for k in ("pred_sub_boxes", "pred_obj_boxes"):
            if not (bool((out[k] > 0).all()) and bool((out[k] < 1).all())):
                raise AssertionError(f"{k} outside (0, 1)")
        return out

    torch.cuda.reset_peak_memory_stats()
    ms_deform_attn.launches = ms_deform_attn.backward_launches = ms_deform_attn.int8_launches = 0
    window_attention.launches = Int8Linear.calls = 0
    _zero_msda_designs()
    t0 = time.perf_counter()
    with _window_launch_shapes() as window_shapes:
        stats = evaluate_hoi(apply_fn, model, dataset, cfg, CachedTextEncoder(encode_fn),
                             batch_size=BATCH, bucket=BUCKET)
    wall = time.perf_counter() - t0
    launches = {**counts(), "msda_bwd": ms_deform_attn.backward_launches}
    designs = _check_designs(tag, launches["msda_fwd"], window_shapes, msda_bwd=launches["msda_bwd"],
                             msda_int8=launches["msda_int8"])
    if sum(window_shapes.values()) != launches["window"]:
        raise AssertionError(f"[{tag}] window launches {window_shapes} against the count {launches['window']}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    if launches["msda_bwd"] != 0:
        raise AssertionError(f"{launches['msda_bwd']} backward launches in evaluation")
    if per_forward != [expected] * N_BATCHES or launches != {
            **{k: v * N_BATCHES for k, v in expected.items()}, "msda_bwd": 0}:
        raise AssertionError(f"launches per forward {per_forward} (expected {expected}), total {launches}")
    for k, v in stats.items():
        if not (math.isfinite(v) and 0.0 <= v <= 1.0):
            raise AssertionError(f"HICO stat {k} = {v}")
    steady = latencies[1:]  # the first batch is warm-up
    result = {
        "model": type(model).__name__,
        "backbone": cfg.backbone.name,
        "msda_impl": cfg.transformer.msda_impl,
        "int8_dense": cfg.transformer.int8_dense,
        "img_per_s": BATCH * len(steady) / sum(steady),
        "p50_ms": 1000 * float(np.median(steady)),
        "warmup_ms": 1000 * latencies[0],
        "peak_mem_gb": peak_gb,
        "eval_wall_s": wall,
        "launches": launches,
        "designs": designs,
        "per_forward": expected,
        "stats": stats,
    }
    log(f"[{tag}] {json.dumps(result)}")
    return result, cfg, model


@contextlib.contextmanager
def _encoder_offset_spread(model):
    """Reads the first encoder layer's sampling offsets (level pixels: the
    layer divides them by each level's (W, H)) at the model's first forward
    inside the block, and fills the yielded dict with the p50 and p90 of
    their lengths |(dx, dy)| over every query, head, level and point."""
    spread = {}

    def hook(module, inputs, out):
        if spread:
            return
        n = torch.linalg.vector_norm(out.detach().float().reshape(-1, 2), dim=-1).sort().values
        spread.update({"n": n.numel(), "p50_px": float(n[n.numel() // 2]),
                       "p90_px": float(n[(9 * n.numel()) // 10])})

    handle = model.transformer.encoder.layers[0].self_attn.sampling_offsets.register_forward_hook(hook)
    try:
        yield spread
    finally:
        handle.remove()


def int8_fidelity_phase(cfg, models: dict) -> tuple[dict, dict]:
    """The exact, int8-MSDA and full-int8 R50 forwards (the same seeded
    weights) on one batch at 832x1344: max |delta| of the verb logits and
    boxes, and the canned-GT mAP protocol of `eval/int8_gate.py` as the JAX
    package's benchmark runs it (exact against each int8 path, the 1 %
    score-jitter control, the p90 relative verb-score error). Printed, not
    gated: with random weights the canned-GT mAP is noise-bound, so a
    degenerate fixture is reported, not raised. Also returns the spread of
    the exact model's first encoder layer's sampling offsets in level
    pixels (`_encoder_offset_spread`), printed once."""
    from rlipv2_tpu_torch.engine.loops import SUBJECT_CATEGORY_ID
    from rlipv2_tpu_torch.eval.int8_gate import map_delta_points
    from rlipv2_tpu_torch.eval.postprocess import postprocess_hoi, to_image_results
    from rlipv2_tpu_torch.tools.main_path import BATCH, BUCKET

    dev = torch.device("cuda")
    rng = np.random.RandomState(0)
    B, (H, W), T = BATCH, BUCKET, cfg.max_obj_texts + cfg.max_verb_texts
    pixels = torch.from_numpy(rng.randint(0, 256, (B, H, W, 3), dtype=np.uint8)).to(dev)
    valid = torch.ones(B, H, W, dtype=torch.bool, device=dev)
    valid[:, 800:, :] = False
    valid[:, :, 1292:] = False
    text = torch.from_numpy(rng.randn(B, T, cfg.text_encoder.hidden_size).astype(np.float32)).to(dev)
    text_valid = torch.ones(B, T, dtype=torch.bool, device=dev)
    orig = torch.tensor([[800.0, 1292.0]] * B, device=dev)
    outs, results = {}, {}
    with torch.no_grad(), _encoder_offset_spread(models["exact"]) as spread:
        for name, model in models.items():
            outs[name] = model(pixels, valid, text, text_valid, cfg.max_obj_texts)
            results[name] = to_image_results(postprocess_hoi(outs[name], orig), SUBJECT_CATEGORY_ID)
    log(f"[spread] eval_r50 first encoder layer's sampling offsets, level pixels: {json.dumps(spread)}")
    nv, no = cfg.max_verb_texts, cfg.max_obj_texts

    def protocol(res):
        try:
            delta, m_e, m_q = map_delta_points(results["exact"], res, nv, no)
            return {"map_delta_points": delta, "exact_map": m_e, "quant_map": m_q}
        except AssertionError as e:  # the protocol's own degenerate-fixture check
            return {"not_measured": str(e)}

    out = {}
    jr = np.random.RandomState(5)
    jittered = [{**r, "verb_scores": np.asarray(r["verb_scores"]) * (1.0 + 0.01 * jr.randn(
        *np.asarray(r["verb_scores"]).shape))} for r in results["exact"]]
    out["score_jitter_1pct_control"] = protocol(jittered)
    for name in ("int8", "full"):
        d = {k: float((outs[name][k].float() - outs["exact"][k].float()).abs().max())
             for k in ("pred_verb_logits", "pred_sub_boxes", "pred_obj_boxes")}
        rels = np.concatenate([
            (np.abs(np.asarray(a["verb_scores"], np.float64) - np.asarray(b["verb_scores"], np.float64))
             / np.maximum(np.asarray(a["verb_scores"], np.float64), 1e-9)).ravel()
            for a, b in zip(results["exact"], results[name])])
        out[name] = {"max_abs_delta": d, "verb_score_rel_err_p90": float(np.percentile(rels, 90)),
                     **protocol(results[name])}
    log(f"[fidelity] {json.dumps(out)}")
    return out, spread


def _zoo_inputs(dataset, dev) -> tuple:
    """The first batch of `dataset` padded into BUCKET as `evaluate_hoi`
    pads it: (pixels (B, H, W, 3) uint8, valid (B, H, W)) on `dev`; seeded
    targets (ZOO_TARGETS pair slots an image, HICO's classes and verbs in
    the heads' 96 object and 160 verb columns); and a GT verb heatmap of
    `data/heatmap.py` from them, (B, 1, H / 4, W / 4)."""
    from rlipv2_tpu_torch.data.heatmap import make_verb_heatmap
    from rlipv2_tpu_torch.structures import HOITargets
    from rlipv2_tpu_torch.tools.main_path import BATCH, BUCKET

    pixels = np.zeros((BATCH, *BUCKET, 3), np.uint8)
    valid = np.zeros((BATCH, *BUCKET), bool)
    for b in range(BATCH):
        img = np.asarray(dataset[b][0])
        pixels[b, :img.shape[0], :img.shape[1]] = img
        valid[b, :img.shape[0], :img.shape[1]] = True
    rng = np.random.RandomState(15)
    B, M = BATCH, ZOO_TARGETS
    real = rng.rand(B, M) < 0.7
    real[:, 0] = True
    verbs = np.zeros((B, M, 160), np.float32)
    verbs[np.arange(B)[:, None], np.arange(M)[None], rng.randint(0, 117, (B, M))] = 1.0
    verbs[:, :, :117] = np.maximum(verbs[:, :, :117], rng.rand(B, M, 117) < 0.01)

    def boxes():
        return np.concatenate([rng.uniform(0.25, 0.75, (B, M, 2)), rng.uniform(0.05, 0.4, (B, M, 2))],
                              -1).astype(np.float32)

    sub, obj = boxes(), boxes()
    hm_hw = (BUCKET[0] // 4, BUCKET[1] // 4)
    scale = np.array([hm_hw[1], hm_hw[0]] * 2, np.float32)

    def xyxy(bx):
        return np.concatenate([bx[:, :2] - bx[:, 2:] / 2, bx[:, :2] + bx[:, 2:] / 2], -1) * scale

    gt_hm = np.stack([make_verb_heatmap(xyxy(sub[b][real[b]]), xyxy(obj[b][real[b]]), hm_hw) for b in range(B)])
    targets = HOITargets(*(torch.from_numpy(a).to(dev) for a in (
        rng.randint(0, 80, (B, M)), np.zeros((B, M), np.int64), verbs, sub, obj, real)))
    return torch.from_numpy(pixels).to(dev), torch.from_numpy(valid).to(dev), targets, torch.from_numpy(gt_hm).to(dev)


def _zoo_loss(out, targets, gt_hm):
    """SetCriterionHOI's weighted total over every head column (all slots
    real), plus `loss_verb_hm` where the model gives `verb_hm`."""
    from rlipv2_tpu_torch.config import LossConfig
    from rlipv2_tpu_torch.losses.criterion import SetCriterionHOI

    crit = SetCriterionHOI(LossConfig())
    B, dev = out["pred_obj_logits"].shape[0], out["pred_obj_logits"].device
    obj_valid = torch.ones((B, out["pred_obj_logits"].shape[-1]), dtype=torch.bool, device=dev)
    verb_valid = torch.ones((B, out["pred_verb_logits"].shape[-1]), dtype=torch.bool, device=dev)
    losses = crit(out, targets, obj_valid, verb_valid)
    if "verb_hm" in out:
        losses.update(crit.loss_verb_hm(out, gt_hm))
    return losses, crit.weighted_total(losses) + losses.get("loss_verb_hm", 0.0), (obj_valid, verb_valid)


def _zoo_backward(tag: str, model, pixels, valid, targets, gt_hm, msda: int) -> dict:
    """Phase 15b: one forward and backward of `_zoo_loss` in train mode:
    the MSDA backward launches equal the forward's (`msda`), on their
    D = 32 designs; every gradient is finite; the prior buffers (OCN,
    Coupled) are no parameters and take no gradient."""
    model.train()
    model.zero_grad(set_to_none=True)
    _zero_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = model(pixels, valid)
    losses, total, _ = _zoo_loss(out, targets, gt_hm)
    total.backward()
    torch.cuda.synchronize()
    step_ms = 1000 * (time.perf_counter() - t)
    launches = _counts()
    designs = _check_designs(tag, launches["msda_fwd"], {}, msda_bwd=launches["msda_bwd"])
    if launches != {"msda_fwd": msda, "msda_bwd": msda, "window": 0, "msda_int8": 0}:
        raise AssertionError(f"[{tag}] launches {launches}, expected {msda} forward and {msda} backward")
    with_grad = [(n, p.grad) for n, p in model.named_parameters() if p.grad is not None]
    bad = [n for n, g in with_grad if not bool(torch.isfinite(g).all())]
    total = float(total.detach())
    if bad or not math.isfinite(total):
        raise AssertionError(f"[{tag}] loss {total}, non-finite gradients of {bad[:5]}")
    priors = {n: b for n, b in model.named_buffers() if n.endswith(ZOO_PRIORS)}
    params = dict(model.named_parameters())
    if any(n in params or b.requires_grad or b.grad is not None for n, b in priors.items()):
        raise AssertionError(f"[{tag}] a prior buffer takes a gradient: {sorted(priors)}")
    model.zero_grad(set_to_none=True)
    model.eval()
    hm = losses.get("loss_verb_hm")
    return {"step_ms": step_ms, "loss": total, "loss_verb_hm": None if hm is None else float(hm.detach()),
            "terms": len([k for k in losses if k.startswith("loss_")]), "params_with_grad": len(with_grad),
            "params": len(params), "prior_buffers": sorted(priors), "launches": launches, "designs": designs,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


def zoo_criterion_phase(captured: dict, targets, gt_hm) -> dict:
    """Phase 15c: `_zoo_loss` on the card against the CPU, float32, on each
    captured 15a output (ZOO_CRITERION), both on the CPU's matching: the
    loss terms (`loss_verb_hm` too) and the gradients with respect to
    every output, within CRITERION_REL_TOL (`_card_against_cpu`)."""
    from rlipv2_tpu_torch.config import LossConfig
    from rlipv2_tpu_torch.losses.criterion import SetCriterionHOI

    cases, t0 = {}, time.perf_counter()
    for v, outputs in captured.items():
        host = {"outputs": _tree_map(lambda t: t.cpu(), outputs), "targets": type(targets)(*(t.cpu() for t in targets)),
                "gt_hm": gt_hm.cpu()}
        layers = [host["outputs"], *host["outputs"]["aux_outputs"]]
        verb_valid = torch.ones((targets.valid.shape[0], outputs["pred_verb_logits"].shape[-1]), dtype=torch.bool)
        matches = SetCriterionHOI(LossConfig()).match(layers, host["targets"], verb_valid)[0]
        own_match = SetCriterionHOI.match

        def same_matching(self, layers, targets, verb_valid):
            _, giou, valid = own_match(self, layers, targets, verb_valid)
            return matches.to(giou.device), giou, valid

        def run(device, outputs=outputs):
            x = _grad_leaves(_tree_map(lambda t: t.to(device), outputs))
            tgt = type(targets)(*(t.to(device) for t in targets))
            SetCriterionHOI.match = same_matching
            try:
                losses, total, _ = _zoo_loss(x, tgt, gt_hm.to(device))
            finally:
                SetCriterionHOI.match = own_match
            total.backward()
            return ({k: float(val.detach()) for k, val in losses.items() if k.startswith("loss_")},
                    float(total.detach()), {k: None if t.grad is None else t.grad.cpu() for k, t in _tree_leaves(x)})

        case = _card_against_cpu(run, f"zoo_{v}")
        case.pop("grads")
        cases[v] = case
    result = {"max_rel_diff": max(max(c["max_rel_loss"], c["max_rel_grad"]) for c in cases.values()),
              "tolerance": CRITERION_REL_TOL, "seconds": time.perf_counter() - t0, "cases": cases}
    log(f"[zoo_criterion] {json.dumps(result)}")
    if result["max_rel_diff"] > CRITERION_REL_TOL:
        raise AssertionError(f"[zoo_criterion] card against CPU {result['max_rel_diff']} > {CRITERION_REL_TOL}")
    return result


def zoo_phase() -> tuple[dict, dict]:
    """Phase 15: the closed-vocabulary zoo at the R50 preset's widths,
    batch 8 at 832x1344, bf16 (`tools/main_path.py::main_path_zoo_model`).
    15a, each variant's batched inference: ZOO_FORWARDS forwards, the first
    warm-up, through `evaluate_hoi` for the MSDA members (no text: the
    evaluator reads the split's columns, `evaluation_columns`) and on the
    val split's first batch for the others; every forward launches the
    MSDA forward ZOO_MSDA_PER_FORWARD times on the D = 32 design and
    nothing else. 15b, `_zoo_backward` for ZOO_BACKWARD; 15c,
    `zoo_criterion_phase`. Returns ({variant: result}, the runs' launches
    by path for the kernels line)."""
    from rlipv2_tpu_torch.data.synthetic import SyntheticHICODataset
    from rlipv2_tpu_torch.engine.loops import CachedTextEncoder, evaluate_hoi
    from rlipv2_tpu_torch.models.closed_vocab import evaluation_columns
    from rlipv2_tpu_torch.models.factory import CLOSED_VOCAB_VARIANTS
    from rlipv2_tpu_torch.tools.main_path import BATCH, BUCKET, main_path_zoo_model

    if set(ZOO_MSDA_PER_FORWARD) != set(CLOSED_VOCAB_VARIANTS):
        raise AssertionError(f"the zoo's variants {CLOSED_VOCAB_VARIANTS} against {sorted(ZOO_MSDA_PER_FORWARD)}")
    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    dataset = SyntheticHICODataset(BATCH * ZOO_FORWARDS, seed=0)
    no_text = CachedTextEncoder(lambda texts: np.zeros((len(texts), 1), np.float32))  # the zoo reads no text
    pixels, valid, targets, gt_hm = _zoo_inputs(dataset, dev)
    results, captured, launches_by_path = {}, {}, {}
    for v in CLOSED_VOCAB_VARIANTS:
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        cfg, model = main_path_zoo_model(dev, v)
        ready_s = time.perf_counter() - t0
        msda = ZOO_MSDA_PER_FORWARD[v]
        latencies, per_forward = [], []

        def apply_fn(m, px, vl, text_emb=None, text_valid=None, n_obj=None, v=v):
            before = _counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = m(px, vl)
            torch.cuda.synchronize()
            latencies.append(time.perf_counter() - t)
            per_forward.append({k: n - before[k] for k, n in _counts().items()})
            for k in ("pred_obj_logits", "pred_verb_logits", "pred_sub_boxes", "pred_obj_boxes"):
                if not bool(torch.isfinite(out[k]).all()):
                    raise AssertionError(f"[zoo_{v}] non-finite {k}")
            for k in ("pred_sub_boxes", "pred_obj_boxes"):
                if not (bool((out[k] > 0).all()) and bool((out[k] < 1).all())):
                    raise AssertionError(f"[zoo_{v}] {k} outside (0, 1)")
            if v in ZOO_CRITERION and v not in captured:
                captured[v] = _tree_map(lambda t: t.detach().clone(), out)
            return out if text_valid is None else evaluation_columns(out, n_obj, text_valid.shape[1] - n_obj)

        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        t0 = time.perf_counter()
        with torch.no_grad():
            if v in ZOO_EVALUATE:
                stats = evaluate_hoi(apply_fn, model, dataset, cfg, no_text, batch_size=BATCH, bucket=BUCKET)
            else:
                stats = None
                for _ in range(ZOO_FORWARDS):
                    apply_fn(model, pixels, valid)
        wall = time.perf_counter() - t0
        launches = _counts()
        designs = _check_designs(f"zoo_{v}", launches["msda_fwd"], {}, msda_bwd=launches["msda_bwd"])
        want = {"msda_fwd": msda, "msda_bwd": 0, "window": 0, "msda_int8": 0}
        if per_forward != [want] * ZOO_FORWARDS:
            raise AssertionError(f"[zoo_{v}] launches per forward {per_forward}, expected {want} x {ZOO_FORWARDS}")
        if stats is not None and not all(math.isfinite(x) and 0.0 <= x <= 1.0 for x in stats.values()):
            raise AssertionError(f"[zoo_{v}] HICO stats {stats}")
        steady = latencies[1:]
        result = {"model": type(model).__name__, "params_m": sum(p.numel() for p in model.parameters()) / 1e6,
                  "head_columns": {"obj": cfg.max_obj_texts, "verb": cfg.max_verb_texts},
                  "p50_ms": 1000 * float(np.median(steady)), "img_per_s": BATCH * len(steady) / sum(steady),
                  "warmup_ms": 1000 * latencies[0], "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                  "ready_s": ready_s, "wall_s": wall, "per_forward": want, "launches": launches, "designs": designs,
                  "stats": stats}
        launches_by_path[f"zoo_{v}"] = launches
        if v in ZOO_BACKWARD:
            result["backward"] = _zoo_backward(f"zoo_{v}_backward", model, pixels, valid, targets, gt_hm, msda)
            launches_by_path[f"zoo_{v}_backward"] = result["backward"]["launches"]
        log(f"[zoo_{v}] {json.dumps(result)}")
        results[v] = result
        del model
    results["criterion"] = zoo_criterion_phase(captured, targets, gt_hm)
    results["seconds"] = time.perf_counter() - t_phase
    log(f"[zoo] phase 15 in {results['seconds']:.1f} s")
    return results, launches_by_path


def _clocks() -> str:
    """The card's SM clock and power draw now, as nvidia-smi reports them."""
    import subprocess

    return subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]


def _dense_forwards(tag: str, model, inputs: tuple, n: int, msda: int = 0) -> dict:
    """`n` forwards of `model` on `inputs` under no_grad, the first warm-up:
    every forward launches the MSDA forward `msda` times (D = 32 design) and
    no other kernel; finite outputs; each dict of HOI boxes in (0, 1).
    Returns p50, img/s, warm-up and peak memory, the SM clock and power
    just after the forwards, and the launches."""
    latencies, per_forward = [], []
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    with torch.no_grad():
        for _ in range(n):
            before = _counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = model(*inputs)
            torch.cuda.synchronize()
            latencies.append(time.perf_counter() - t)
            per_forward.append({k: c - before[k] for k, c in _counts().items()})
            for k, v in _tree_leaves(out):
                if not bool(torch.isfinite(v).all()):
                    raise AssertionError(f"[{tag}] non-finite {k}")
            for k in ("pred_sub_boxes", "pred_obj_boxes"):
                if k in out and not (bool((out[k] > 0).all()) and bool((out[k] < 1).all())):
                    raise AssertionError(f"[{tag}] {k} outside (0, 1)")
    clocks = _clocks()
    launches = _counts()
    designs = _check_designs(tag, launches["msda_fwd"], {}, msda_bwd=launches["msda_bwd"])
    want = {"msda_fwd": msda, "msda_bwd": 0, "window": 0, "msda_int8": 0}
    if per_forward != [want] * n:
        raise AssertionError(f"[{tag}] launches per forward {per_forward}, expected {want} x {n}")
    steady = latencies[1:]
    return {"p50_ms": 1000 * float(np.median(steady)), "img_per_s": inputs[0].shape[0] * len(steady) / sum(steady),
            "warmup_ms": 1000 * latencies[0], "forwards": n, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "clocks_after": clocks, "per_forward": want, "launches": launches, "designs": designs}


def _label_text_features(model, cfg, dataset, dev):
    """(text_emb (B, T, 768), text_valid (B, T), n_obj) for BATCH images:
    the pooled features of the split's object texts, the no-object text and
    its verb texts, from the model's text encoder or a seeded RoBERTa-base
    (`main_path.pooled_text_encoder`), as `evaluate_hoi` feeds them."""
    from rlipv2_tpu_torch.data.synthetic import hash_tokenize
    from rlipv2_tpu_torch.tools import main_path
    from rlipv2_tpu_torch.tools.main_path import BATCH

    texts = list(dataset.object_text) + ["no objects"] + list(dataset.verb_text)
    n_obj = len(dataset.object_text) + 1
    encode_text = getattr(model, "encode_text", None) or main_path.pooled_text_encoder(cfg, dev)
    ids, mask = hash_tokenize(texts, cfg.text_encoder.vocab_size, maxlen=16)
    with torch.no_grad():
        feats = encode_text(torch.from_numpy(ids).to(dev), torch.from_numpy(mask).to(dev))
    return (feats[None].expand(BATCH, *feats.shape).contiguous(),
            torch.ones((BATCH, len(texts)), dtype=torch.bool, device=dev), n_obj)


def detector_state_dict(layout: str, model) -> dict:
    """A seeded full-width detector state dict in the reference key space of
    `layout` (dab_ddetr: DAB-Deformable-DETR with box refinement; ddetr:
    Deformable-DETR with box refinement; detr: DETR), its names and shapes
    taken from the HOI model the converter warm-starts (`model`, the
    detector parts under the detector's own names), plus the detector's
    parts that no converter reads (the COCO class heads), with
    DETECTOR_QUERIES queries; drawn by `synth_state_dict` with seed 16, as
    torch tensors (a `.pth`'s `model` entry)."""
    import re

    from rlipv2_tpu_torch.tools.golden_pack import synth_state_dict

    own = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    d, nq = own["projection_text.weight"][0], DETECTOR_QUERIES[layout]
    shapes = {k: v for k, v in own.items() if k.startswith(("backbone.0.body.", "input_proj.",
                                                             "transformer.encoder.layers.", "transformer.level_embed"))}
    if layout == "detr":
        rename = {"transformer.ho_decoder.": "transformer.decoder.", ".cross_attn_image.": ".multihead_attn.",
                  ".norm3.": ".norm2.", ".norm4.": ".norm3."}
        for k, v in own.items():
            if k.startswith("transformer.ho_decoder."):
                for a, b in rename.items():
                    k = k.replace(a, b)
                shapes[k] = v
            elif k.startswith("sub_bbox_embed."):
                shapes["bbox_embed." + k.split(".", 1)[1]] = v
        shapes.update({"query_embed.weight": (nq, d), "class_embed.weight": (DETECTOR_CLASSES + 1, d),
                       "class_embed.bias": (DETECTOR_CLASSES + 1,)})
    else:
        dec = "transformer.ho_decoder." if layout == "dab_ddetr" else "transformer.ho_decoder_nd."
        for k, v in own.items():
            if k.startswith(dec + "layers.") or (layout == "dab_ddetr" and k.startswith(
                    (dec + "ref_point_head.", dec + "query_scale."))):
                shapes["transformer.decoder." + k[len(dec):]] = v
        n_dec = 1 + max(int(re.match(r"transformer\.decoder\.layers\.(\d+)\.", k)[1])
                        for k in shapes if k.startswith("transformer.decoder.layers."))
        head = {k.split(".", 2)[2]: v for k, v in own.items() if k.startswith("sub_bbox_embed.0.")}
        for layer in range(n_dec):
            for name, shape in head.items():  # the box-refinement clones, under both names
                shapes[f"transformer.decoder.bbox_embed.{layer}.{name}"] = shape
                shapes[f"bbox_embed.{layer}.{name}"] = shape
            shapes[f"class_embed.{layer}.weight"], shapes[f"class_embed.{layer}.bias"] = \
                (DETECTOR_CLASSES, d), (DETECTOR_CLASSES,)
        if layout == "dab_ddetr":
            shapes.update({"tgt_embed.weight": (nq, d), "refpoint_embed.weight": (nq, 4)})
        else:
            shapes.update({"query_embed.weight": (nq, 2 * d), "transformer.reference_points.weight": (2, d),
                           "transformer.reference_points.bias": (2,)})
    names = sorted(shapes)
    arrays = synth_state_dict(names, [shapes[k] for k in names], ["float32"] * len(names), seed=16)
    return {k: torch.from_numpy(v) for k, v in arrays.items()}


def dense_variants_phase(dataset, pixels, valid) -> tuple[dict, dict]:
    """Phase 16a: ParSe-DAB-DETR (`main_path_zoo_model`: 96 object and 160
    verb head columns) and RLIP-MDETR (`main_path_rlipv1_model`: HICO's
    slots, label features from a seeded RoBERTa-base) at the R50 preset's
    widths, batch 8 at 832x1344, bf16: DENSE_FORWARDS forwards each on the
    val split's first batch (`_dense_forwards`: no kernel launch)."""
    from rlipv2_tpu_torch.tools import main_path

    dev = pixels.device
    results, launches_by_path = {}, {}
    for tag, (builder, variant) in DENSE_VARIANTS.items():
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        cfg, model = getattr(main_path, builder)(dev, variant)
        ready_s = time.perf_counter() - t0
        inputs = (pixels, valid)
        if variant == "rlip_mdetr":
            inputs += _label_text_features(model, cfg, dataset, dev)
        result = {"model": type(model).__name__, "params_m": sum(p.numel() for p in model.parameters()) / 1e6,
                  "ready_s": ready_s, **_dense_forwards(tag, model, inputs, DENSE_FORWARDS)}
        log(f"[{tag}] {json.dumps(result)}")
        results[tag], launches_by_path[tag] = result, result["launches"]
        del model
    return results, launches_by_path


def warm_start_phase(dataset, pixels, valid, tmp: str) -> tuple[dict, dict]:
    """Phase 16b: for each of WARM_STARTS, a seeded full-width detector
    state dict in its reference key space (`detector_state_dict`) written
    as a `.pth` and read back by `read_checkpoint`, converted and
    loaded over the HOI model's seeded init
    (`main_path.main_path_warm_start_model`); every converted tensor must
    sit bit-equal in the model on the card, and the keys left at init are
    counted; then WARM_FORWARDS forwards on the val split's first batch with
    the label texts (`_dense_forwards`): the MSDA forward launches
    WARM_STARTS gives a forward and nothing else."""
    import argparse
    import dataclasses
    import os

    from rlipv2_tpu_torch.config import rlip_parseda_v2_r50
    from rlipv2_tpu_torch.engine.convert import read_checkpoint
    from rlipv2_tpu_torch.models.factory import build_model
    from rlipv2_tpu_torch.tools.main_path import main_path_warm_start_model

    dev = pixels.device
    results, launches_by_path = {}, {}
    for tag, (variant, layout, msda) in WARM_STARTS.items():
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        path = os.path.join(tmp, f"{layout}.pth")
        with torch.device("meta"):  # the HOI model's shapes only
            shapes_of = build_model(dataclasses.replace(rlip_parseda_v2_r50(), variant=variant))
        detector = detector_state_dict(layout, shapes_of)
        t1 = time.perf_counter()
        torch.save({"model": detector, "args": argparse.Namespace(num_queries=DETECTOR_QUERIES[layout])}, path)
        detector = read_checkpoint(path)["model"]
        pth_mb = os.path.getsize(path) / 1e6
        os.remove(path)
        t2 = time.perf_counter()
        cfg, model, partial, left = main_path_warm_start_model(detector, dev, variant)
        t3 = time.perf_counter()
        setup = {"detector_s": t1 - t0, "pth_write_read_s": t2 - t1, "pth_mb": pth_mb, "build_convert_load_s": t3 - t2}
        own = model.state_dict()
        unequal = [k for k, v in partial.items() if not torch.equal(own[k].cpu(), torch.from_numpy(v))]
        if unequal:
            raise AssertionError(f"[{tag}] converted tensors not bit-equal in the model: {unequal[:5]}")
        inputs = (pixels, valid, *_label_text_features(model, cfg, dataset, dev))
        result = {"model": type(model).__name__, "detector": layout, "detector_tensors": len(detector),
                  "converted_keys": len(partial), "bit_equal": len(partial), "keys_left_at_init": len(left),
                  "model_keys": len(own), "left_at_init_prefixes": sorted({".".join(k.split(".")[:2]) for k in left}),
                  "setup": setup, **_dense_forwards(tag, model, inputs, WARM_FORWARDS, msda)}
        log(f"[{tag}] {json.dumps(result)}")
        results[tag], launches_by_path[tag] = result, result["launches"]
        del model, detector, partial
    return results, launches_by_path


def _coco_detections(post: dict, image_ids) -> list:
    """`postprocess_detection`'s output -> COCO results [{image_id,
    category_id, bbox xywh, score}], the class index as the COCO category id
    (DETR's 91-way head is indexed so)."""
    scores, labels, boxes = (post[k].cpu().numpy() for k in ("scores", "labels", "boxes"))
    xywh = np.concatenate([boxes[..., :2], boxes[..., 2:] - boxes[..., :2]], -1)
    return [{"image_id": int(img), "category_id": int(labels[b, j]), "bbox": [float(x) for x in xywh[b, j]],
             "score": float(scores[b, j])} for b, img in enumerate(image_ids) for j in range(scores.shape[1])]


def detector_phase(pixels, valid, tmp: str) -> tuple[dict, dict]:
    """Phase 16c: `DETRDetector` with DETECTOR_CLASSES classes at the R50
    preset's widths, batch 8 at 832x1344, bf16
    (`main_path.main_path_detector_model`): DETECTOR_FORWARDS forwards (no
    kernel launch, finite outputs); DETECTOR_STEPS forwards and backwards
    of `detection_losses` on seeded targets (DETECTOR_TARGETS boxes an
    image, some padded) in train mode, every gradient finite; `postprocess_detection`
    and `coco_evaluate` over a seeded COCO GT json of the 8 images (the
    same boxes in each image's pixels), timed on the wall clock. The AP is
    printed, not checked: the weights are random."""
    import os

    from rlipv2_tpu_torch.engine.convert import COCO_OBJ_IDS
    from rlipv2_tpu_torch.models.detection import coco_evaluate, detection_losses, postprocess_detection
    from rlipv2_tpu_torch.tools.main_path import main_path_detector_model

    dev = pixels.device
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cfg, model = main_path_detector_model(dev, DETECTOR_CLASSES)
    ready_s = time.perf_counter() - t0
    forward = _dense_forwards("detector", model, (pixels, valid), DETECTOR_FORWARDS)

    rng = np.random.RandomState(16)
    B, M = pixels.shape[0], DETECTOR_TARGETS
    tvalid = rng.rand(B, M) < 0.8
    tvalid[:, 0] = True
    labels = rng.choice(COCO_OBJ_IDS[:-1], (B, M))
    boxes = np.concatenate([rng.uniform(0.25, 0.75, (B, M, 2)), rng.uniform(0.05, 0.4, (B, M, 2))], -1)
    boxes[~tvalid] = 0.0
    targets = [torch.from_numpy(a).to(dev) for a in (labels, boxes.astype(np.float32), tvalid)]
    model.train()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    step_ms = []
    for _ in range(DETECTOR_STEPS):  # the first is a process's first backward of this graph
        model.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        t = time.perf_counter()
        losses = detection_losses(model(pixels, valid), *targets, num_classes=DETECTOR_CLASSES)
        total = sum(v for k, v in losses.items() if k.startswith("loss_"))
        total.backward()
        torch.cuda.synchronize()
        step_ms.append(1000 * (time.perf_counter() - t))
    total = float(total.detach())
    bad = [n for n, p in model.named_parameters() if p.grad is not None and not bool(torch.isfinite(p.grad).all())]
    if bad or not math.isfinite(total) or _counts() != {"msda_fwd": 0, "msda_bwd": 0, "window": 0, "msda_int8": 0}:
        raise AssertionError(f"[detector] loss {total}, non-finite gradients of {bad[:5]}, {_counts()}")
    backward = {"step_ms": step_ms, "step_p50_ms": float(np.median(step_ms[1:])),
                "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                "losses": {k: float(v.detach()) for k, v in losses.items()}, "launches": _counts()}
    model.zero_grad(set_to_none=True)
    model.eval()

    t = time.perf_counter()
    # each image's size: its valid rows and columns, (B, 2) as (h, w)
    hw = torch.stack([valid.any(2).sum(1), valid.any(1).sum(1)], 1)
    sizes = hw.cpu().numpy()
    with torch.no_grad():
        post = postprocess_detection(model(pixels, valid), hw)
    image_ids = list(range(1, B + 1))
    annos = []
    for b in range(B):
        h, w = sizes[b]
        for m in np.flatnonzero(tvalid[b]):
            cx, cy, bw, bh = boxes[b, m] * [w, h, w, h]
            annos.append({"id": len(annos) + 1, "image_id": image_ids[b], "category_id": int(labels[b, m]),
                          "bbox": [float(cx - bw / 2), float(cy - bh / 2), float(bw), float(bh)],
                          "area": float(bw * bh), "iscrowd": 0})
    gt = {"images": [{"id": i, "height": int(sizes[b, 0]), "width": int(sizes[b, 1])}
                     for b, i in enumerate(image_ids)],
          "categories": [{"id": c, "name": str(c)} for c in COCO_OBJ_IDS[:-1]], "annotations": annos}
    gt_path = os.path.join(tmp, "detector_gt.json")
    with open(gt_path, "w") as f:
        json.dump(gt, f)
    summary = coco_evaluate(_coco_detections(post, image_ids), gt_path)
    coco_s = time.perf_counter() - t
    if not all(math.isnan(v) or 0.0 <= v <= 1.0 for v in summary.values()):
        raise AssertionError(f"[detector] COCO summary {summary}")
    result = {"model": type(model).__name__, "classes": DETECTOR_CLASSES,
              "params_m": sum(p.numel() for p in model.parameters()) / 1e6, "ready_s": ready_s, **forward,
              "backward": backward, "coco": {"wall_s": coco_s, "detections": int(post["scores"].numel()),
                                             "gt_boxes": len(annos), "summary": summary}}
    log(f"[detector] {json.dumps(result)}")
    del model
    return result, {"detector": forward["launches"], "detector_backward": backward["launches"]}


def phase16(tmp: str) -> tuple[dict, dict]:
    """Phase 16: 16a `dense_variants_phase`, 16b `warm_start_phase`, 16c
    `detector_phase`, on the synthetic val split's first batch padded into
    BUCKET (`_zoo_inputs`). Returns ({tag: result}, the launches by path
    for the kernels line)."""
    from rlipv2_tpu_torch.data.synthetic import SyntheticHICODataset
    from rlipv2_tpu_torch.tools.main_path import BATCH

    t0 = time.perf_counter()
    dataset = SyntheticHICODataset(BATCH, seed=0)
    pixels, valid, _, _ = _zoo_inputs(dataset, torch.device("cuda"))
    results, launches = dense_variants_phase(dataset, pixels, valid)
    more_results, more_launches = warm_start_phase(dataset, pixels, valid, tmp)
    results.update(more_results)
    launches.update(more_launches)
    results["detector"], more_launches = detector_phase(pixels, valid, tmp)
    launches.update(more_launches)
    results["seconds"] = time.perf_counter() - t0
    log(f"[phase16] phase 16 in {results['seconds']:.1f} s")
    return results, launches


def main() -> None:
    import tempfile

    t_start = time.perf_counter()
    t_last = [t_start]

    def elapsed(tag: str) -> None:
        """The phase `tag`'s seconds and the script's so far."""
        now = time.perf_counter()
        log(f"[elapsed] {tag} {now - t_last[0]:.1f} s, {now - t_start:.1f} s in all")
        t_last[0] = now

    smi = device_phase()
    build_phase()
    elapsed("build")
    l2_rate = l2_read_rate()
    cases = kernel_phase(l2_rate)
    int8_cases, int8_timing = int8_kernel_phase(l2_rate)
    window_cases, window_fwd, window_grads = window_phase()
    log(f"[quoted, not measured in this run] earlier designs' ms per call, PERF.md section 6: "
        f"{json.dumps(QUOTED_EARLIER_MS)}")
    elapsed("kernels 3, 3c, 3b")
    golden_pack_phase()
    exact = {"msda_fwd": MSDA_PER_FORWARD, "msda_int8": 0, "window": 0}
    int8 = {"msda_fwd": 0, "msda_int8": MSDA_PER_FORWARD, "window": 0}
    runs, models = {}, {}
    runs["eval_r50"], cfg, models["exact"] = main_path_phase("eval_r50", "main_path_model", exact)
    runs["eval_r50_int8"], _, models["int8"] = main_path_phase("eval_r50_int8", "main_path_int8_model", int8)
    runs["eval_r50_int8_full"], _, models["full"] = main_path_phase(
        "eval_r50_int8_full", "main_path_int8_model", int8, dense=True)
    if runs["eval_r50_int8_full"]["per_forward"]["int8_linear"] == 0:
        raise AssertionError("the full int8 model has no int8 projection")
    fidelity, offset_spread = int8_fidelity_phase(cfg, models)
    elapsed("golden pack and R50 inference 4, 5, 5c, 5d, 5e")
    del models
    gc.collect()  # the R50 models go before the Swin-L one is built
    torch.cuda.empty_cache()
    runs["eval_swin_l"], _, _ = main_path_phase(
        "eval_swin_l", "main_path_swin_model", {**exact, "window": WINDOW_PER_FORWARD})
    gc.collect()
    torch.cuda.empty_cache()
    elapsed("Swin-L inference 5b")
    bwd_cases, bwd_timing = backward_phase(l2_rate)
    elapsed("backward 6")
    train = train_phase()
    elapsed("train 7")
    gc.collect()
    torch.cuda.empty_cache()
    # the fine-tune trees' parts that phases 8, 11, 12a and 13a-c share
    shared = tempfile.TemporaryDirectory(prefix="finetune_parts_")
    finetune, finetune_tree = finetune_phase(shared.name)
    elapsed("finetune 8")
    gc.collect()
    torch.cuda.empty_cache()
    pretrain = pretrain_phase()
    elapsed("pretrain 9")
    gc.collect()
    torch.cuda.empty_cache()
    finetune_swin = swin_train_phase("finetune_swinL", "finetune_hico_swinL", SWIN_FINETUNE_STEPS, 1,
                                     evaluate=True, use_checkpoint=SWIN_FINETUNE_CHECKPOINT)
    elapsed("finetune_swinL 10a")
    gc.collect()
    torch.cuda.empty_cache()
    pretrain_swin = swin_train_phase("pretrain_swinL", "pretrain_mixed_vgcocoo365_swinL", SWIN_PRETRAIN_STEPS,
                                     SWIN_PRETRAIN_MICRO, evaluate=False, use_checkpoint=SWIN_PRETRAIN_CHECKPOINT)
    elapsed("pretrain_swinL 10b")
    downstream = {}
    for tag in DOWNSTREAM_SCRIPTS:
        gc.collect()
        torch.cuda.empty_cache()
        downstream[tag] = downstream_phase(tag, shared.name)
    elapsed("V-COCO and OI-SGG 11")
    for tag in PARSED_SCRIPTS:
        gc.collect()
        torch.cuda.empty_cache()
        downstream[tag] = downstream_phase(tag, shared.name)
    elapsed("finetune_hico_parsed 12a")
    gc.collect()
    torch.cuda.empty_cache()
    tagger, tagger_tmp, tagger_ckpt = tagger_train_phase()
    gc.collect()
    torch.cuda.empty_cache()
    elapsed("tagger training 12b")
    generate = tagger_generate_phase(tagger_tmp, tagger_ckpt)
    elapsed("tagger inference 12c")
    for tag in RLIPV1_SCRIPTS:
        gc.collect()
        torch.cuda.empty_cache()
        downstream[tag] = downstream_phase(tag, shared.name)
    for tag, (variant, msda) in RLIPV1_EVALS.items():
        gc.collect()
        torch.cuda.empty_cache()
        runs[tag], _, _ = main_path_phase(tag, "main_path_rlipv1_model", {**exact, "msda_fwd": msda},
                                          variant=variant)
    elapsed("RLIPv1 13")
    gc.collect()
    torch.cuda.empty_cache()
    heads = heads_phase(finetune_tree.name, finetune["step_p50_ms"])
    finetune_tree.cleanup()
    elapsed("loss and head options 14")
    gc.collect()
    torch.cuda.empty_cache()
    _, phase17_launches = dp_phase(shared.name)
    shared.cleanup()  # phases 14 and 17 read phase 8's tree parts
    elapsed("data-parallel training and the sharded evaluation 17")
    gc.collect()
    torch.cuda.empty_cache()
    zoo, zoo_launches = zoo_phase()
    elapsed("closed-vocabulary zoo 15")
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="phase16_") as tmp16:
        _, phase16_launches = phase16(tmp16)
    elapsed("factory variants, warm starts and the detector 16")
    enc = next(r for r in cases if r["case"] == "encoder/bfloat16")
    bwd, bwd_grid, bwd_dec = (bwd_timing[k] for k in ("encoder", "encoder_init_grid", "decoder_q200"))
    i8, i8_grid = int8_timing["encoder"], int8_timing["encoder_init_grid"]
    big = next(r for r in window_cases if r["case"] == "stage0/masked/bfloat16")

    def by_path(eval_key, train_key):
        return {**{path: run["launches"][eval_key] for path, run in runs.items()},
                "train": train["launches"][train_key], "finetune_hico": finetune["launches"][train_key],
                "pretrain_mixed": pretrain["launches"][train_key],
                "finetune_swinL": finetune_swin["launches"][eval_key],
                "pretrain_swinL": pretrain_swin["launches"][eval_key],
                **{tag: run["launches"][eval_key] for tag, run in downstream.items()},
                "tagger_train_vg": tagger["launches"][eval_key], "tagger_generate_coco": generate["launches"][eval_key],
                **{tag: heads[tag]["launches"][eval_key] for tag in HEADS_SCRIPTS},
                **{path: launches[eval_key] for path, launches in zoo_launches.items()},
                **{path: launches[eval_key] for path, launches in phase16_launches.items()},
                **{path: launches[eval_key] for path, launches in phase17_launches.items()}}

    # no single PyTorch call computes MSDA (grid_sample covers one level)
    rows = {
        "ms_deform_attn_fwd": dict(
            launches_by_path=by_path("msda_fwd", "fwd"), max_abs_err=enc["max_abs_err"], ms=enc["ms"],
            design=MSDA_MAIN_DESIGN,
            plain_ms=enc["plain_ms"], bound_ms=enc["bound_ms"], bound_by=enc["bound_by"],
            bound_rate=enc["bound_rate"], l2_bytes=enc["l2_bytes"], l2_ms=enc["l2_ms"],
            l2_read_rate=enc["l2_read_rate"], library_ms=None, cases=cases),
        # the backward alone at the encoder shape, B 8, bf16, uniform
        # locations; at init-grid locations and at the decoder shape beside it
        "ms_deform_attn_bwd": dict(
            launches_by_path=by_path("msda_bwd", "bwd"), design=MSDA_BWD_MAIN_DESIGN,
            max_abs_err=bwd["max_abs_err"], ms=bwd["ms"], ms_init_grid=bwd_grid["ms"],
            ms_decoder_q200=bwd_dec["ms"], plain_ms=bwd["plain_ms"], bound_ms=bwd["bound_ms"],
            bound_by=bwd["bound_by"], bound_rate=bwd["bound_rate"], bound_ms_init_grid=bwd_grid["bound_ms"],
            bound_ms_decoder_q200=bwd_dec["bound_ms"], l2_bytes=bwd["l2_bytes"], l2_ms=bwd["l2_ms"],
            l2_bytes_init_grid=bwd_grid["l2_bytes"], l2_ms_init_grid=bwd_grid["l2_ms"],
            l2_read_rate=l2_rate, library_ms=None, main_path_offset_spread=offset_spread,
            timing=bwd_timing, cases=bwd_cases),
        # one call at the largest shape, Swin-L stage 0 with the shift mask,
        # bf16; the totals of a forward's 24 calls under per_forward
        "window_attention_fwd": dict(
            launches_by_path=by_path("window", "window"), max_abs_err=big["max_abs_err"], ms=big["ms"],
            plain_ms=big["plain_ms"], bound_ms=big["bound_ms"], bound_by=big["bound_by"],
            bound_rate=big["bound_rate"], library_ms=big["library_ms"],
            library="torch.nn.functional.scaled_dot_product_attention", per_forward=window_fwd,
            backward=big["backward"], per_step_swinL={
                "launches": {tag: run["launches_per_step"]["window"]
                             for tag, run in (("finetune_swinL", finetune_swin), ("pretrain_swinL", pretrain_swin))},
                "backward_calls_per_micro_batch": {
                    tag: run["window_backward_calls_per_micro_batch"]
                    for tag, run in (("finetune_swinL", finetune_swin), ("pretrain_swinL", pretrain_swin))},
                **{k: window_fwd[k] for k in ("backward_ms", "backward_plain_ms", "backward_library_ms",
                                              "backward_bound_ms")}},
            grad_check=window_grads, cases=window_cases),
        # the kernel alone on ready codes at the encoder shape, bf16; the
        # quantize pass and the whole int8 path beside it
        "ms_deform_attn_int8_fwd": dict(
            launches_by_path=by_path("msda_int8", "int8"), design=MSDA_INT8_MAIN_DESIGN,
            max_abs_err=i8["max_abs_err"], ms=i8["ms"], ms_init_grid=i8_grid["ms"], plain_ms=i8["plain_ms"],
            bound_ms=i8["bound_ms"], bound_by=i8["bound_by"], bound_rate=i8["bound_rate"],
            bound_ms_init_grid=i8_grid["bound_ms"], l2_bytes=i8["l2_bytes"], l2_ms=i8["l2_ms"],
            l2_read_rate=l2_rate, library_ms=None,
            quantize_ms=i8["quantize_ms"], quantize_bound_ms=i8["quantize_bound_ms"],
            int8_path_ms=i8["int8_path_ms"], exact_kernel_ms=i8["exact_kernel_ms"],
            fidelity=fidelity, cases=int8_cases),
    }
    kernels = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         "launches": sum(rows[name]["launches_by_path"].values()), **rows[name]}
        for name, (src, replaces) in KERNELS.items()
    ]}
    log(smi)
    log(json.dumps(kernels))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--phase17-rank"]:
        phase17_rank(sys.argv[2:])
    else:
        main()
