"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. device   a CUDA card must be present; prints `nvidia-smi` name, power limit
  2. build    compiles every CUDA source (nms_suppress.cu, int8_conv.cu)
              and host C++ library (imgcodec.cpp, native.cpp) into
              build/kernels/, all at once
  3. kernels  each kernel against its plain PyTorch version on the card, at
              the serving and training paths' shapes and beyond
              (nms_suppress: B=128 at k = 256, 512, 1024, 2048; B=1 at
              k=512; B=8 at k = 1,024 (validation), 8,400 and 8,683), in
              its IoU and its DIoU mode (DIoU also at DIOU_NEG_THR for
              k <= 2,048): the keep masks must be equal; prints kernel,
              mask-pass, scan and plain ms beside the bound
  4. fp32     edge_n @640, 2 images, TF32 off: card (kernel) against CPU
              (plain version)
  5. serve    edge_n @640 at full width, seeded heads and the bundled
              MobileNetV4 backbone weights, bf16 channels_last, through
              Predictor.infer_batched_stream (b128), Predictor.infer_image and
              YoloLite.predict; the kernel launch counts must grow; prints
              img/s and per-stage ms
  6. zoo      every detection config under configs/ (15; read with the port's
              own YAML reader, 3 classes) at full width and depth, seeded
              weights with BatchNorm statistics set from one forward: fp32
              card vs CPU at 640 (TF32 off; batched_nms on equal inputs
              bit-exact), then bf16 channels_last serving at 640 b128
              (Predictor.infer_batched_stream, device-resident, 2 runs of 4
              batches, and one YoloLite.predict frame) with the kernel's
              launches counted; prints params, img/s, forward ms, top kernel
Then, on a synthetic PNG set written from a seed (32 train / 8 val images
at 640x480, 1-4 coloured rectangles on dark noise):
  7. augment  host augmentation on this machine (numpy, no cv2): 64 samples
              each of the base and strong presets from fixed seeds, every
              branch counted by wrappers (flips, affine, the five colour
              ops, noise, blur, mosaic, cutmix, elastic, dropout, shadow,
              flare), a second pass on 8 threads equal to the first; host ms
              per op and per sample; the loader's ms per batch of 8 with
              augmentation on and off
  8. train    edge_n @640 b8 bf16 trained for 2 epochs by YoloLite.train
              (standard_train.yaml with its host augmentation, tapered in
              epoch 2; backbone frozen in epoch 1, the bundled backbone):
              finite loss, falling val loss, every artifact, best/last
              checkpoints served by the Predictor, nms_suppress launches
              equal to the val batches the run implies, an exact resume of
              epoch 2 from the full state of the same run stopped after
              epoch 1; an fp32 step card vs CPU on unaugmented batches
              (equal assignment); step (augmented batches), loader, eval
              and profiler numbers
  9. device_augment  the photometric step card vs CPU on equal draws
              (within 1 level), its ms at b8 and b64, and one epoch of
              edge_n b8 by hardsynth_device_aug.yaml (device_augment: true)
 10. seg      instance segmentation: edge_n_seg fp32 card vs CPU at 640
              (level maps, prototypes, mask probabilities of equal inputs,
              binarized frame masks); both seg configs served at 640 b128
              bf16 device-resident with masks assembled for every max_det
              slot (per-stage ms, mask assembly included, peak GB) and one
              YoloLite(ckpt, task="segment").predict frame with uint8 masks,
              nms_suppress launches counted; edge_n_seg trained 2 epochs at
              640 b8 by standard_train.yaml on a synthetic polygon set (seg
              mosaic and cutmix counted, finite mask loss, falling val loss,
              coco_segm, launches equal to the val batches), an fp32
              forward+loss card vs CPU, the step timed and split
 11. codecs   the host image codecs (csrc/imgcodec.cpp and csrc/webpcodec.cpp,
              built in phase 2 by this machine's C++ compiler): every
              fixture under tests/data/codecs/ (JPEG, CMYK JPEG, BMP, PNG,
              TIFF, WebP) decodes to the SHA-256 of cv2.imread's output
              recorded in its manifest; host decode ms per 640x480 image
              (baseline and progressive JPEG, PNG, TIFF as cv2.imwrite
              writes it, lossy and lossless WebP) on 1 and 8 threads; the
              loader's ms per b8 batch on a JPEG copy of the set against
              the PNG set; edge_n trained 1 epoch at 640 b8 by the recipe's
              defaults on the JPEG copy and on a TIFF copy written by the
              port's TIFF writer (nms_suppress launches counted on
              validation); YoloLite.predict on a JPEG path and a JPEG
              folder, a TIFF path and a WebP path, boxes equal to the same
              frames as arrays; pretrain_backbone 1 epoch on an imagefolder
              of the WebP and CMYK JPEG fixtures
 12. stream   edge_n @640 bf16 over a 120-frame synthetic 480x640 clip:
              Predictor.infer_stream at depth 0-3 yields exactly
              infer_image's boxes, scores and classes on every frame, one
              nms_suppress launch a frame; KalmanSortTracker over the
              stream gives infer_image's tracks; frames/s a depth, serial
              infer_image ms, tracker ms, `_upload`'s share of host time,
              the registered op's host cost a call
 13. export   edge_n and edge_n_seg as "raw", "decoded" and "nms" `.pt2`
              (torch.export) at b128 @640, fp32 and bf16, from a saved
              checkpoint, loaded back and held against the Predictor's
              eager graph (fp32 within 1e-4 of the outputs' scale, "nms"
              valid and classes equal; bf16 "nms" >= 99% matched at IoU
              0.99; seg masks <= 1e-3 of pixels), one nms_suppress launch an
              "nms" call; the bf16 "nms" artifact's ms against the graph's,
              peak GB; edge_n ONNX ("raw", "decoded", a dynamic-batch file)
              run on the host by the port's runner against the card's fp32
              "decoded" (1e-3); YoloLite.export() once
 14. quant    the Predictor's deploy variants, QAT and the host C++ library,
              edge_n @640 b128 bf16 with the serve phase's weights: the
              three int8 kernels (csrc/int8_conv.cu) against their plain
              versions (x_q, s_x, int32 accumulators, output: equal) at
              every distinct quantized conv call of edge_n and edge_n_seg at
              b128 and of every other detection config at b2, timed at
              edge_n's beside their bounds and torch._int_mm (1x1), the
              quantize's launch plan logged per call beside the yardstick
              vector_norm(x, inf) (its max pass alone);
              Predictor(quantize="int8") img/s from device and host batches
              beside bf16 in turns with every kernel's launches counted, the
              stage split (each int8 kernel's time filed by its CUDA
              symbols; a launched kernel with none fails, and so do more
              quantize kernels a call than launches, or a memset), peak GB, the
              share of int8 detections bf16
              finds, the card's fp32 int8 against the CPU's (>= 99%
              matched); one edge_n_seg int8 b128 call; 10 QAT steps of
              edge_n b8 beside plain ones, an int8 Predictor serving the
              QAT checkpoint; Predictor(s2d_stem=True) against the folded
              one (fp32 within 1e-4, bf16 >= 99% matched at IoU 0.99), img/s
              in turns, the host pack's ms (C++ and numpy); evaluate_model
              with the C++ and the Python matcher (equal stats, both times)
              and nms_numpy on one "decoded" output
 15. cli      every command-line tool of the port through its main(argv),
              in-process, edge_n @640 on the PNG set: train (1 epoch b8,
              standard_train.yaml, the bundled backbone; artifacts and
              nms_suppress launches of its validation), evaluate bf16 and
              --quantize int8 on the best checkpoint, its head logits
              scaled to a standard deviation of CLI_LOGIT_STD, over the val
              images labelled with bf16's own best detections (finite
              stats, bf16 AP50 >= CLI_MIN_AP50, every int8 kernel launched,
              int8's AP/AP50/AP75/AR within CLI_INT8_STAT_TOL of bf16's,
              ms/img; then every
              distinct quantized conv call of the b8 batch it fed its model
              against the plain versions), infer on the val folder with --save_txt
              --save_json (equal to YoloLite.predict), export "nms" and
              "decoded" .pt2 and a "decoded" ONNX, each through
              infer_exported on one frame against the fp32 Predictor, and
              tracker over 60 frames of the synthetic clip written as a PNG
              sequence (tracks equal to KalmanSortTracker over infer_image);
              each tool's wall seconds and launches. import_backbone is held
              on the CPU only (the card's machine has neither JAX nor timm)
 16. draw     drawing and the offline weather tool (host numpy; the card's
              machine has no cv2), edge_n @640 with the cli phase's sharpened
              checkpoint: host ms of draw_detections, the JPEG q95 and PNG
              encoders on a 640x480 frame and of each weather effect;
              YoloLite.predict(draw=True, save_dir=) on a PNG folder, a JPEG
              folder and an array; infer's *_pred.jpg; infer_exported --out on
              the "nms" .pt2; tracker over 60 frames of the stream phase's
              clip (a BMP sequence) without --out, to an mp4v .avi (luma at
              VIDEO_LUMA_PSNR_DB or more of each drawn frame) and to a JPEG
              sequence (frames/s of each); a 6-epoch run on 8 + 8 images
              (sanity_check.jpg, last_b0/1.jpg of epoch 6); augment_weather over
              the training images in YOLO and COCO layout and one epoch on the
              YOLO copy's JPEGs. Every file written decodes with the port's
              codecs to the canvas drawn (JPEG byte for byte the encoder's
              output, re-encoded for 1 in DRAW_REENCODE_EVERY, and at least
              DRAW_PSNR_DB of it), nms_suppress launched as each step implies
 17. video    video files on the card's host (data/video.py, csrc/videocodec.cpp;
              no cv2 there): every clip of tests/data/video decoded, its
              packets, fps, frame count, size and each frame's SHA-256 equal
              to cv2's in the manifest (the truncated clip's concealed last
              frame by count only; the WebM raises); 60 of make_clip's
              frames at 480x640 written as .mp4 by the port's writer and read back
              (count and rate exact, luma at VIDEO_LUMA_PSNR_DB or more);
              tracker --device cuda on that .mp4 and on the same decoded
              frames as a PNG sequence, each without and with --out out.mp4:
              equal tracks, nms_suppress launched a frame and once for the
              warmup; host ms to decode a 640x480 I-VOP, P-VOP and
              Motion-JPEG frame and to encode a frame, the .mp4's size, and
              the tracker's frames/s of each run. H.264 (csrc/h264dec.cpp):
              every clip of tests/data/video/h264 (libx264's, 12 decoded, 6
              refused kinds) held to cv2's manifest the same way, each
              refused kind raising UnsupportedVideo naming its tool; host ms
              a picture by type (I, P, B) at 640x480 and 1920x1080 and to
              convert one to BGR; tracker --device cuda on the 640x480 H.264
              .mp4 with --out out.mp4 and on its frames as a PNG sequence:
              equal tracks, nms_suppress launched a frame and for the warmup
 18. tools    the remaining user tools through their entry points, on the
              same PNG set: model_info --all (12 configs @640) on the card,
              its table logged, parameters and FLOPs equal to the CPU's;
              pretrain_backbone (MobileNetV4-Conv-S-050, 25 epochs b32 @224)
              on an imagefolder of JPEG crops of the set's boxes written by
              the port's make_crop_corpus (finite, falling loss; EMA val top-1
              above the majority class's share), its checkpoint loaded into
              a 1-epoch edge_n run through pretrained_backbone (the backbone
              at step 0 equal to it); benchmark --epochs 1 --batch_size 8
              --bench_batch 128 (a non-zero row; nms_suppress launched by
              validation, the 51 latency calls and the 13 graph calls, as
              predicted; its batched img/s beside serve's); the loop's
              profile flag on a 2-epoch run (one trace, holding CUDA kernel
              events)
 19. synth    the dataset generators on the card's host (numpy, through
              each tool's main(argv)): make_hard_synth 32 + 8 at base 640
              (boxes) and 16 + 8 (--seg), make_synth_dataset 32 + 8 at 320
              (plain and --seg_polygons), make_crop_corpus of the HardSynth
              set, make_cls_corpus 8 + 2 a class at 160; host ms an image,
              every JPEG decoded within DRAW_PSNR_DB of its canvas, every
              label row parsed by the dataset readers. Then edge_n @640
              trained 2 epochs b8 by hardsynth_device_aug.yaml (validation
              every epoch) on HardSynth through tools.train (finite, falling
              loss), tools.evaluate on its best checkpoint (finite stats),
              edge_n_seg 1 epoch on the --seg set (finite mask loss),
              pretrain_backbone 2 epochs on the class corpus (finite loss);
              the trained edge_n's raw outputs on the 8 val images (8,400
              anchors) suppressed at top-k 512 and 8,400, IoU and DIoU, iou
              0.65 and DIOU_NEG_THR: keep masks equal to the plain version's
              on the same tensors on the CPU, then batched_nms on the card
              (launches counted, DIoU apart) bit for bit the plain
              detections
 20. ddp      data-parallel training, edge_n @640 at full width: two ranks
              spawned on this one card over gloo (NCCL refuses two ranks on
              one device) against one process at the same global batch and
              weights: a b16 step (8 a rank) in fp32 (TF32 off) and bf16,
              the bf16 one against one process on the ranks' BatchNorm path
              (loss, metrics, the reduced gradients, BatchNorm statistics;
              DDP_FP32 / DDP_BF16), each rank's reduced gradient bit for bit
              the sum of the ranks' local ones, the ranks' parameters, EMA
              and optimizer state bitwise equal after 3 steps, the
              collectives a step and their ms, the step's ms at world 1 and
              2; then
              train_from_config with data_parallel 2 joined to the ranks'
              group, 2 epochs b8 on the PNG set (nms_suppress launched by
              each rank's share of validation, rank 1 writing nothing, the
              final COCO equal to one process's evaluate_model of the best
              checkpoint); with 2 cards the same over NCCL, else a world-1
              NCCL group
 21. spatial  spatial parallelism (the image height split over ranks),
              yololite_l + P6 @1280 at full width and depth on a 1280x1280
              PNG set, seeded weights with calibrated BatchNorm statistics:
              n_data 1 x n_spatial 2 ranks on this card over gloo against
              one process, a b2 step in fp32 (TF32 off) and bf16 (against
              one process on the ranks' BatchNorm path; SP_FP32 / SP_BF16),
              each reduced gradient bit for bit the sum of the local ones,
              the ranks' state bitwise equal after 3 steps, the halo and
              gather collectives a step with their bytes, each rank's peak
              memory; the eval step's detections equal to one process's
              (nms_suppress launched by each rank); then train_from_config
              with spatial_parallel 2 joined to the ranks' group for 1
              epoch, its final COCO equal to one process's evaluate_model of
              its best checkpoint and its AP within SP_AP_TOL of one
              process's run; with 2 or more cards the step over NCCL, a rank
              a card (2 x 2 on 4)
Then one JSON line with every kernel's numbers, and last the result line
{"ok": true, "device": {...}}. A copy of the numbers goes to
chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import contextlib
import copy
import glob
import hashlib
import io
import json
import os
import shutil
import struct
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from yololite_tpu_torch.api import YoloLite  # noqa: E402
from yololite_tpu_torch.config import read_yaml  # noqa: E402
from yololite_tpu_torch.config.config import MODEL_DIRS, dump_yaml, load_configs  # noqa: E402
from yololite_tpu_torch.convert import load_flax, to_flax  # noqa: E402
from yololite_tpu_torch.csrc import build as kbuild  # noqa: E402
from yololite_tpu_torch.data import augment as host_aug  # noqa: E402
from yololite_tpu_torch.data import codecs as host_codecs  # noqa: E402
from yololite_tpu_torch.data import device_augment as dev_aug  # noqa: E402
from yololite_tpu_torch.data import imgops  # noqa: E402
from yololite_tpu_torch.data import video as host_video  # noqa: E402
from yololite_tpu_torch.data import weather  # noqa: E402
from yololite_tpu_torch.data.imwrite import (  # noqa: E402
    JPEG_QUALITY, encode_jpeg, write_bmp, write_jpeg, write_png, write_tiff,
)
from yololite_tpu_torch.data.dataset import (  # noqa: E402
    YoloDataset, parse_yolo_label_file, parse_yolo_seg_file,
)
from yololite_tpu_torch.data.loader import DataLoader, collate  # noqa: E402
from yololite_tpu_torch import native  # noqa: E402
from yololite_tpu_torch.deploy import export as deploy_export  # noqa: E402
from yololite_tpu_torch.deploy import infer_exported as deploy_infer_exported  # noqa: E402
from yololite_tpu_torch.deploy import s2d as deploy_s2d  # noqa: E402
from yololite_tpu_torch.deploy.fold_norm import normalize_images  # noqa: E402
from yololite_tpu_torch.deploy.predictor import PRE_NMS_TOPK, Predictor  # noqa: E402
from yololite_tpu_torch.eval.evaluate import evaluate_model  # noqa: E402
from yololite_tpu_torch.models.detector import (  # noqa: E402
    DetectHead, build_model_from_config, count_params, init_weights,
)
from yololite_tpu_torch.models.layers import BatchNorm  # noqa: E402
from yololite_tpu_torch.ops import cuda_int8, cuda_nms, quant  # noqa: E402
from yololite_tpu_torch.losses.simota import mask_losses  # noqa: E402
from yololite_tpu_torch.ops.decode import decode_anchorfree, flatten_levels  # noqa: E402
from yololite_tpu_torch.ops.masks import assemble_masks_batch  # noqa: E402
from yololite_tpu_torch.parallel import dist as pdist  # noqa: E402
from yololite_tpu_torch.ops.nms import (  # noqa: E402
    _greedy_keep, _suppression_matrix, batched_nms, finalize_detections, nms_numpy,
    select_candidates, yolo_scores,
)
from yololite_tpu_torch.train.checkpoint import (  # noqa: E402
    build_meta, load_checkpoint, model_from_meta, save_checkpoint,
)
from yololite_tpu_torch.train import loop as train_loop  # noqa: E402
from yololite_tpu_torch.train.loop import CSV_HEADER  # noqa: E402
from yololite_tpu_torch.train.steps import Trainer, gt_masks_from_batch  # noqa: E402
from yololite_tpu_torch.track import KalmanSortTracker  # noqa: E402
from yololite_tpu_torch.tools import evaluate as cli_evaluate  # noqa: E402
from yololite_tpu_torch.tools import export as cli_export  # noqa: E402
from yololite_tpu_torch.tools import infer as cli_infer  # noqa: E402
from yololite_tpu_torch.tools import infer_exported as cli_infer_exported  # noqa: E402
from yololite_tpu_torch.tools import tracker as cli_tracker  # noqa: E402
from yololite_tpu_torch.tools import train as cli_train  # noqa: E402
from yololite_tpu_torch.tools import benchmark as cli_benchmark  # noqa: E402
from yololite_tpu_torch.tools import model_info as cli_model_info  # noqa: E402
from yololite_tpu_torch.tools import pretrain_backbone as cli_pretrain  # noqa: E402
from yololite_tpu_torch.tools import augment_weather as cli_augment  # noqa: E402
from yololite_tpu_torch.tools import make_cls_corpus as cli_make_cls  # noqa: E402
from yololite_tpu_torch.tools import make_crop_corpus as cli_make_crops  # noqa: E402
from yololite_tpu_torch.tools import make_hard_synth as cli_make_hs  # noqa: E402
from yololite_tpu_torch.tools import make_synth_dataset as cli_make_synth  # noqa: E402
from yololite_tpu_torch.utils.viz import draw_detections  # noqa: E402

IMG = 640
BATCH = 128
EDGE_N = {"model": {"arch": "YOLOLiteMS_CPU", "backbone": "mobilenetv4_conv_small_050",
                    "depth_multiple": 0.65, "width_multiple": 0.60,
                    "fpn_channels": 160, "head_depth": 1, "num_classes": 3,
                    "num_anchors_per_level": 1}}
BACKBONE_CKPT = os.path.join(ROOT, "weights", "mnv4_050_cls20.ckpt")
# H100 SXM published peaks (NVIDIA H100 datasheet): fp32 outside the
# tensor cores, and HBM bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12
IOU_FLOPS_PER_PAIR = 15   # 4 min/max, 4 sub, 2 clamp, 1 mul, 2 add, 1 div, 1 cmp
# DIoU adds 2 sub, 2 mul, 1 add (d2), 2 max, 2 min, 2 sub, 2 mul, 2 add (c2),
# 1 div, 1 sub a pair (csrc/nms_suppress.cu); the centres are per box
DIOU_FLOPS_PER_PAIR = IOU_FLOPS_PER_PAIR + 17
DIOU_NEG_THR = -0.1       # a DIoU threshold below 0: the kernel computes every column
SLEEP_CYCLES_PER_MS = 2.0e6   # at most ~2 GHz SM clock: a sleep at least this long
NMS_CASES = [(BATCH, 256), (BATCH, PRE_NMS_TOPK), (BATCH, 1024), (BATCH, 2048),
             (1, PRE_NMS_TOPK), (8, 1024),    # (B, k); B=8 k=1024: the val batch of
             (8, 8400),                       # the train phase; k=8,400: every anchor
             (8, 8683)]                       # ConvNeXtV2-tiny's 81²+41²+21² anchors
# every detection config, with its parameter count at 3 classes (the JAX
# package's count, held in tests/test_torch_port_zoo_detectors.py)
ZOO_PARAMS = {
    "configs/models/edge_l.yaml": 4_351_608,
    "configs/models/edge_m.yaml": 2_948_948,
    "configs/models/edge_n.yaml": 549_640,
    "configs/models/edge_s.yaml": 2_359_736,
    "configs/models/edge_xl.yaml": 9_344_168,
    "configs/models/yololite_l.yaml": 30_379_544,
    "configs/models/yololite_m.yaml": 13_924_752,
    "configs/models/yololite_n.yaml": 6_293_616,
    "configs/models/yololite_s.yaml": 9_369_368,
    "configs/models/yololite_xl.yaml": 44_597_528,
    "configs/v2_models/yololite_l.yaml": 52_219_704,
    "configs/v2_models/yololite_m.yaml": 17_913_598,
    "configs/v2_models/yololite_n.yaml": 8_921_632,
    "configs/v2_models/yololite_s.yaml": 12_431_916,
    "configs/custom/custom.yaml": 5_338_840,
}
# fp32 card vs CPU, two checks. (1) Both are fp32 evaluations of one
# function, so each is held against an fp64 forward (on the card) of the
# same weights and image: the card's max abs error there must stay within
# ZOO_FP32_FACTOR times the CPU fp32 forward's own (cuDNN may pick other conv
# algorithms, such as Winograd, whose rounding differs by a small factor; a
# wrong op or weight errs by the outputs' scale). (2) Card vs CPU directly,
# within ZOO_FP32_RTOL of the outputs' scale. The seeded nets' BatchNorm
# divides some channels by a small calibrated std, which amplifies rounding:
# the CPU fp32's own error against fp64 reaches ~1.4e-4 of the scale
# (HGNetV2-B0, whose ReLU taps leave channels of small std), so two fp32
# forwards may differ by about twice that; 1e-3 leaves room.
ZOO_FP32_FACTOR = 10.0
ZOO_FP32_RTOL = 1e-3
ZOO_BATCHES, ZOO_RUNS = 4, 2
# train phase: edge_n @640 b8, standard_train.yaml with these overrides
# (augment: true, the recipe's default: mosaic and cutmix in epoch 1, tapered
# off in epoch 2 as int(0.7 * 2) = 1). data_parallel 1: unset, training takes
# every visible card, so on a host with several this pins every phase before
# `ddp` to one process on cuda:0 (its launch counts and patches are this
# process's)
TRAIN_OVERRIDES = dict(epochs=2, batch_size=8, img_size=640, augment=True, amp=True,
                       freeze_backbone_epochs=1, pretrained_backbone=BACKBONE_CKPT,
                       save_optimizer=True, data_parallel=1)
TRAIN_N, VAL_N = 32, 8
# augment phase: samples per preset, each from RandomState(seed base + i)
AUG_SAMPLES = 64
AUG_SEEDS = {"base": 1000, "strong": 2000}
# every branch of host augmentation, each counted by a wrapper: module
# functions of data/augment.py, its COLOR_OPS, the dataset's mix-ins
AUG_FUNCS = ("hflip", "vflip", "random_affine", "gauss_noise", "motion_blur",
             "elastic_transform", "coarse_dropout", "add_shadow", "add_sunflare")
AUG_MIXES = ("mosaic", "cutmix_focus_small")
# device_augment: the train phase's batch and hardsynth_device_aug.yaml's
DEVAUG_BATCHES = (8, 64)
# Exact resume: the resumed run's epoch-2 mean train loss against the
# straight run's, within 1e-3 relative. It came out bit-exact on the card,
# but cuDNN may pick nondeterministic weight-gradient algorithms, which
# would move bf16 losses by far less than this; a weights-only resume (fresh
# EMA and optimizer, printed beside it as a control) misses by ~1.5e-2.
RESUME_RTOL = 1e-3
# fp32 card vs CPU train step, TF32 off: loss components within 1e-3
# relative (fp32 forwards differ by ~1e-6 relative, and the hard-negative
# top-K picks anchors by value, so near-ties at its boundary swap terms).
# The loss's backward on equal level outputs: within 1e-6 relative L2 (the
# same fp32 ops; sums reorder). The model's backward is ill-conditioned in
# train mode: BatchNorm divides each channel by its batch std, and near-
# constant channels of this seeded net on dark synthetic images amplify
# rounding (a 1e-6 relative change of the weights moves the CPU's own
# gradient by ~2e-3 in relative L2, and the card's fp32 convolutions round
# otherwise than the CPU's), so each fp32 backward is held against the CPU's
# fp64 one from the same upstream gradient: the card's error within
# TRAIN_FP32_FACTOR x the CPU fp32's own. Updated parameters within 2.1 x
# lr_max (Adam's first step is lr * g / |g|, so an element whose gradient is
# at rounding level may step either way).
TRAIN_FP32_LOSS_RTOL = 1e-3
TRAIN_FP32_LOSS_GRAD_RTOL = 1e-6
TRAIN_FP32_FACTOR = 10.0
# seg phase: both segmentation configs, their parameter counts at 3 classes
# (the JAX package's, held in tests/test_torch_port_zoo_detectors.py)
SEG_CONFIGS = ("configs/models/edge_n_seg.yaml", "configs/models/yololite_n_seg.yaml")
SEG_PARAMS = {"configs/models/edge_n_seg.yaml": 728_328,
              "configs/models/yololite_n_seg.yaml": 7_011_104}
SEG_BATCHES = 4
# fp32 card vs CPU: mask probabilities of equal inputs within 1e-3 (an fp32
# matmul over K = 32 and a sigmoid; ~1e-6 expected); binarized frame masks
# may differ on 1e-3 of the pixels (a probability within rounding of 0.5
# falls on either side, and the forward's own 1e-6 differences move it)
SEG_PROB_TOL = 1e-3
SEG_PIXEL_SHARE = 1e-3
SEG_MIXES = ("mosaic_segment", "cutmix_segment")
SEG_TRAIN_OVERRIDES = dict(TRAIN_OVERRIDES, save_optimizer=False)
# stream phase: a synthetic 480x640 clip from seed 0, infer_stream at each
# depth; the tracker takes each frame's TRACK_TOP best detections (this
# seeded net has no confident ones to threshold on)
STREAM_FRAMES = 120                 # 240 before, cut for the time limit
STREAM_DEPTHS = (0, 1, 2, 3)
TRACK_TOP = 32
# export phase: fp32 artifacts against the eager graph (TF32 off) within
# EXPORT_FP32_RTOL of the outputs' scale (the same ATen ops on the same card;
# equal in practice); bf16 "nms" detections matched at IoU >= 0.99 for at
# least EXPORT_BF16_MATCH of them; seg masks binarized at 0.5 differing on at
# most SEG_PIXEL_SHARE of the pixels; ONNX on the host against the card's
# fp32 "decoded" within ONNX_TOL (rtol and atol: JAX's own bound for its ONNX
# file, here across two devices' fp32 convolutions)
EXPORT_FP32_RTOL = 1e-4
EXPORT_BF16_MATCH = 0.99
ONNX_TOL = 1e-3
# TFLite in the export phase: batch-1 files of edge_n and edge_n_seg run by
# the port's numpy runner on the host on TFLITE_IMAGES images, held against
# the card's fp32 graph (TF32 off): fp32 "raw"/"decoded" within
# TFLITE_FP32_TOL (abs and rel); fp16 "decoded" within TFLITE_QUANT_TOL of
# each output's scale (the larger of 1 and its max abs; edge_n_seg's at 640
# px on the CPU: 8.7e-3), dynamic int8 "decoded" by its mean error over each
# output's mean magnitude (int8 activations, one scale an image a layer:
# edge_n_seg's prototypes 0.125, max errors 0.27 of scale, on the CPU); the
# "decoded" keep (batched_nms on the card) and the "nms" detections equal the
# Predictor's at a conf in a wide gap of its scores (`_tflite_conf`).
# Launches a model: the Predictor's keep, the "decoded" file's keep, the
# Predictor's "nms" graph.
TFLITE_IMAGES = 2
TFLITE_FP32_TOL = 1e-4
TFLITE_QUANT_TOL = {"fp16": 2e-2, "dynamic": 0.25}
TFLITE_FILES = (("raw", None), ("decoded", None), ("nms", None), ("decoded", "fp16"),
                ("decoded", "dynamic"))
TFLITE_LAUNCHES = 3
EXPORT_CONFIGS = ("configs/models/edge_n.yaml", "configs/models/edge_n_seg.yaml")
KERNELS = [{"name": "nms_suppress", "route": "cuda", "source": cuda_nms.SOURCE,
            "replaces": "yololite_tpu/ops/pallas_nms.py:74"}] + [
    {"name": name, "route": "cuda", "source": cuda_int8.SOURCE, "replaces": replaces}
    for name, replaces in (("int8_quantize", "yololite_tpu/ops/quant.py:42 (XLA, no Pallas)"),
                           ("int8_conv_dense", "yololite_tpu/ops/quant.py:48 (XLA, no Pallas)"),
                           ("int8_conv_depthwise",
                            "yololite_tpu/ops/quant.py:48 (XLA, no Pallas)"))]
KERNEL_SOURCES = ["nms_suppress", "int8_conv"]      # csrc/<name>.cu
HOST_LIBS = ["imgcodec", "webpcodec", "videocodec", "h264dec", "hevcdec", "native"]   # host C++
#   (csrc/*.cpp): image and video codecs (H.264 in h264dec); NMS, matcher, pack
CODEC_FIXTURES = os.path.join(ROOT, "tests", "data", "codecs")


def log(msg=""):
    print(msg, flush=True)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of fn() over `iters` back-to-back calls (CUDA events).

    The calls are queued behind a sleep kernel that outlasts their host-side
    launch time, so the device runs them back to back and a short kernel is
    not paced by the host's launch overhead."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(1.5 * iters * host_ms + 1.0, 200.0) * SLEEP_CYCLES_PER_MS))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# --------------------------------------------------------------------------- #
def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs an NVIDIA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    return card


def phase_build():
    """Every CUDA source (nvcc: the NMS and int8 kernels) and every host C++
    library (the image codec; NMS, matcher and s2d pack), one compiler
    process per source, started together."""
    t0 = time.perf_counter()
    secs = kbuild.build(KERNEL_SOURCES + HOST_LIBS)
    for name, s in secs.items():
        log(f"build {name}: {s:.2f} s" if s else f"build {name}: cached "
            f"({kbuild.library_path(name).name} was already built)")
        for line in kbuild.BUILD_LOG.get(name, "").splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  {line.strip()}")
    log(f"build total: {time.perf_counter() - t0:.2f} s")


def _dense_boxes(rng, b, k):
    """Dense overlapping boxes in a 640 px image, class-shifted like the
    serving path (3 classes, coord_bound 8192), and the 30-box alternating
    suppression chain in the first slots of image 0."""
    cx, cy = rng.rand(2, b, k) * IMG
    w, h = rng.rand(2, b, k) * 120 + 8
    boxes = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    boxes += (rng.randint(0, 3, (b, k)) * 8192.0)[..., None]
    n = min(30, k)
    boxes[0, :n] = np.stack([np.arange(n) * 20.0, np.zeros(n),
                             np.arange(n) * 20.0 + 100.0, np.full(n, 50.0)], 1)
    valid = rng.rand(b, k) > 0.1
    valid[0, :n] = True
    return (torch.from_numpy(boxes.astype(np.float32)).cuda(),
            torch.from_numpy(valid).cuda())


def nms_bound_ms(keep: torch.Tensor, valid: torch.Tensor, per_pair: int = IOU_FLOPS_PER_PAIR):
    """Least time for the suppression on this data: the IoUs (or DIoUs, at
    `per_pair` operations) exact greedy needs (each kept box against every
    later valid candidate) at the fp32 rate, or the bytes (boxes and valid
    in, keep out) at the memory rate."""
    later_valid = valid.flip(-1).cumsum(-1).flip(-1) - valid.long()
    pairs = int((later_valid * keep).sum())
    b, k = keep.shape
    ops = pairs * per_pair
    nbytes = b * k * (16 + 1 + 1)                # boxes f32, valid, keep
    t_ops, t_bytes = ops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_BYTES_S * 1e3
    return (t_ops, "operations", pairs) if t_ops >= t_bytes else (t_bytes, "bytes", pairs)


def _launch_split(boxes, valid, iou_th, diou: bool = False):
    """The kernel's two launches as separate calls, for timing them apart
    (not counted in cuda_nms.LAUNCHES)."""
    lib = cuda_nms.library()
    b, k = valid.shape
    scratch = torch.empty((b, k, cuda_nms.mask_words(k)), dtype=torch.int32, device="cuda")
    keep = torch.empty((b, k), dtype=torch.bool, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def check(err, name):
        if err != 0:
            raise RuntimeError(f"{name} launch failed: CUDA error {err}")

    def mask():
        check(lib.yl_nms_mask(boxes.data_ptr(), valid.data_ptr(), scratch.data_ptr(),
                              b, k, iou_th, int(diou), stream), "yl_nms_mask")

    def scan():
        check(lib.yl_nms_scan(scratch.data_ptr(), valid.data_ptr(), keep.data_ptr(),
                              b, k, stream), "yl_nms_scan")
    return mask, scan, keep


def _kernel_diou(card: str, boxes, valid, thr: float, many: int) -> dict:
    """The DIoU mode against its plain version on one case's inputs, timed
    beside its bound (DIOU_FLOPS_PER_PAIR over the pairs its keep mask needs)."""
    b, k = valid.shape
    got = cuda_nms.greedy_keep(boxes, valid, thr, True)
    want = cuda_nms.greedy_keep_reference(boxes, valid, thr, True)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"nms_suppress DIoU B={b} k={k}: "
                             f"{int((got != want).sum())} keep bits differ")
    mask, scan, split_keep = _launch_split(boxes, valid, thr, diou=True)
    mask()
    scan()
    torch.cuda.synchronize()
    if not torch.equal(split_keep, got):
        raise AssertionError(f"nms_suppress DIoU B={b} k={k}: split launches differ")
    if k <= 2048:                      # every column computed: no prefilter below 0
        neg = cuda_nms.greedy_keep(boxes, valid, DIOU_NEG_THR, True)
        if not torch.equal(neg, cuda_nms.greedy_keep_reference(boxes, valid,
                                                               DIOU_NEG_THR, True)):
            raise AssertionError(f"nms_suppress DIoU B={b} k={k} at {DIOU_NEG_THR}: "
                                 f"keep masks differ")
    ms = cuda_ms(lambda: cuda_nms.greedy_keep(boxes, valid, thr, True), many)
    ms_mask = cuda_ms(mask, many)
    plain = cuda_ms(lambda: cuda_nms.greedy_keep_reference(boxes, valid, thr, True), 3, 1)
    bound, by, pairs = nms_bound_ms(got, valid, DIOU_FLOPS_PER_PAIR)
    log(f"kernel nms_suppress DIoU B={b} k={k}: equal keep masks ({int(got.sum())} kept); "
        f"kernel {ms:.4f} ms (mask {ms_mask:.4f}), plain {plain:.4f} ms, bound "
        f"{bound:.4f} ms ({by}, {pairs} pairs at {DIOU_FLOPS_PER_PAIR} op) [{card}]")
    return {"err": int((got.int() - want.int()).abs().max()), "ms_diou": ms,
            "ms_mask_diou": ms_mask, "plain_ms_diou": plain, "bound_ms_diou": bound,
            "bound_by_diou": by, "pairs_diou": pairs, "kept_diou": int(got.sum())}


def phase_kernels(card: str):
    rng = np.random.RandomState(0)
    rows, max_err, thr = {}, 0, 0.65
    for b, k in NMS_CASES:
        boxes, valid = _dense_boxes(rng, b, k)
        got = cuda_nms.greedy_keep(boxes, valid, thr)
        want = cuda_nms.greedy_keep_reference(boxes, valid, thr)
        torch.cuda.synchronize()
        err = int((got.int() - want.int()).abs().max())
        max_err = max(max_err, err)
        if err:
            bad = int((got != want).sum())
            raise AssertionError(f"nms_suppress B={b} k={k}: {bad} keep bits differ")
        if k >= 30 and int(got[0, :30].sum()) != 15:
            raise AssertionError("nms_suppress: the 30-box chain must keep 15")
        mask, scan, split_keep = _launch_split(boxes, valid, thr)
        mask()
        scan()
        torch.cuda.synchronize()
        if not torch.equal(split_keep, got):
            raise AssertionError(f"nms_suppress B={b} k={k}: split launches differ")
        many = 50 if b * k <= 2 ** 17 else 20
        ms = cuda_ms(lambda: cuda_nms.greedy_keep(boxes, valid, thr), many)
        ms_mask = cuda_ms(mask, many)
        ms_scan = cuda_ms(scan, many)
        plain = cuda_ms(lambda: cuda_nms.greedy_keep_reference(boxes, valid, thr), 3, 1)
        bound, by, pairs = nms_bound_ms(got, valid)
        key = f"B{b}_k{k}"
        rows[key] = {"batch": b, "k": k, "ms": ms, "ms_mask": ms_mask, "ms_scan": ms_scan,
                     "plain_ms": plain, "bound_ms": bound, "bound_by": by,
                     "pairs": pairs, "kept": int(got.sum())}
        log(f"kernel nms_suppress B={b} k={k}: equal keep masks ({int(got.sum())} kept); "
            f"kernel {ms:.4f} ms (mask {ms_mask:.4f}, scan {ms_scan:.4f}), "
            f"plain {plain:.4f} ms, bound {bound:.4f} ms ({by}, {pairs} pairs) [{card}]")
        del got, want, mask, scan, split_keep
        torch.cuda.empty_cache()
        rows[key].update(_kernel_diou(card, boxes, valid, thr, many))
        max_err = max(max_err, rows[key].pop("err"))
        del boxes, valid
        torch.cuda.empty_cache()
    chain = torch.tensor([[i * 20.0, 0.0, i * 20.0 + 100.0, 50.0] for i in range(30)],
                         device="cuda")[None]
    keep = cuda_nms.greedy_keep(chain.contiguous(),
                                torch.ones(1, 30, dtype=torch.bool, device="cuda"), 0.5)
    if keep[0].tolist() != [i % 2 == 0 for i in range(30)]:
        raise AssertionError("nms_suppress: chain of 30 must keep every other box")
    log("kernel nms_suppress: 30-box chain keeps every other box (exact greedy)")
    return rows, max_err


def _edge_n_model(seed: int = 0):
    model = init_weights(build_model_from_config(EDGE_N), seed)
    sd, meta = load_checkpoint(BACKBONE_CKPT)      # backbone subtree at top level
    load_flax(model.backbone, sd["params"], sd["batch_stats"])
    return model.eval()


def _match(card_dets, cpu_dets, box_tol, score_tol):
    """Fraction of card detections with a CPU detection of the same class,
    box within box_tol px and score within score_tol."""
    hits = 0
    for (b, s, c), (cb, cs, cc) in zip(card_dets, cpu_dets):
        for i in range(len(b)):
            same = ((cc == c[i]) & (np.abs(cb - b[i]).max(-1) <= box_tol)
                    & (np.abs(cs - s[i]) <= score_tol))
            hits += bool(same.any())
    total = sum(len(b) for b, _, _ in card_dets)
    return hits / max(total, 1), total


def phase_fp32(card: str):
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        model = _edge_n_model()
        meta = {"img_size": IMG, "names": ["c0", "c1", "c2"]}
        gpu = Predictor((model, model.state_dict(), meta), device="cuda",
                        dtype=torch.float32)
        cpu = Predictor((model, model.state_dict(), meta), device="cpu",
                        dtype=torch.float32)
        imgs = (np.random.RandomState(1).rand(2, IMG, IMG, 3) * 255).astype(np.uint8)
        with torch.inference_mode():
            og = gpu.forward(torch.from_numpy(imgs).cuda())
            oc = cpu.forward(torch.from_numpy(imgs))
            err = max(float((a.cpu() - b).abs().max()) for a, b in zip(og, oc))
            scale = max(float(b.abs().max()) for b in oc)
            dec_c = _decode_scores(oc)
            dec_g = _decode_scores([o.cuda() for o in oc])
            dec_err = float((dec_g[0].cpu() - dec_c[0]).abs().max())
            # NMS of the SAME decoded inputs: kernel on the card vs the plain
            # fixpoint on the CPU must agree bit for bit, padding included
            kw = dict(iou_th=0.45, conf_th=0.001, max_det=300, pre_nms_topk=PRE_NMS_TOPK)
            ng = batched_nms(*(t.cuda() for t in dec_c), **kw)
            nc = batched_nms(*dec_c, **kw)
            for name, a, b in zip(("boxes", "scores", "classes", "valid", "idx"), ng, nc):
                if not torch.equal(a.cpu(), b):
                    raise AssertionError(f"fp32 batched_nms {name}: card != CPU")
        log(f"fp32 forward card vs CPU: max abs err {err:.3e} over |x| <= {scale:.2f} "
            f"(tolerance 1e-3); decoded boxes max abs err {dec_err:.3e} px "
            f"(tolerance 1e-2); batched_nms on equal inputs bit-exact")
        if err > 1e-3 or dec_err > 1e-2:
            raise AssertionError(f"fp32 forward/decode differ: {err}, {dec_err}")
        dets_g = [gpu.infer_image(im[..., ::-1], conf=0.001) for im in imgs]
        dets_c = [cpu.infer_image(im[..., ::-1], conf=0.001) for im in imgs]
        frac, total = _match(dets_g, dets_c, 1e-2, 1e-5)
        n_c = sum(len(d[0]) for d in dets_c)
        log(f"fp32 end to end: {total} card / {n_c} CPU detections, "
            f"{frac:.4f} of card detections matched (need >= 0.99)")
        if total == 0 or frac < 0.99 or abs(total - n_c) > 0.01 * n_c:
            raise AssertionError("fp32 end-to-end detections disagree")
        return {"fwd_max_abs_err": err, "dets": total, "matched": frac}
    finally:
        torch.backends.cudnn.allow_tf32 = True


def phase_serve(card: str, n_batches: int = 8, rounds: int = 3, n_single: int = 20):
    model = _edge_n_model()
    log(f"edge_n: {count_params(model)} params, img {IMG}, batch {BATCH}, bf16 channels_last")
    meta = {"img_size": IMG, "names": ["c0", "c1", "c2"]}
    pred = Predictor((model, model.state_dict(), meta), device="cuda",
                     dtype=torch.bfloat16)
    rng = np.random.RandomState(2)
    host = [(rng.rand(BATCH, IMG, IMG, 3) * 255).astype(np.uint8) for _ in range(2)]
    dev = [torch.from_numpy(h).cuda() for h in host]
    frames = [(rng.rand(480, 640, 3) * 255).astype(np.uint8) for _ in range(3)]
    kw = dict(conf=0.001, iou=0.45, max_det=300)
    pred.warmup(**kw)
    list(pred.infer_batched_stream(dev[:1], prepared=True, **kw))
    torch.cuda.synchronize()

    def stream(batches):
        """img/s and detections of one infer_batched_stream pass (depth 2)."""
        t0 = time.perf_counter()
        dets = sum(len(r["boxes"]) for out in pred.infer_batched_stream(
            (batches[i % 2] for i in range(n_batches)), prepared=True, depth=2, **kw)
            for r in out)
        return n_batches * BATCH / (time.perf_counter() - t0), dets

    cuda_nms.LAUNCHES = 0
    runs_host = [stream(host) for _ in range(rounds)]
    runs_dev = [stream(dev) for _ in range(rounds)]
    singles = [pred.infer_image_profiled(frames[i % len(frames)], **kw)
               for i in range(n_single)]
    api = YoloLite((model, model.state_dict(), meta)).predict(frames[:2], **kw)
    torch.cuda.synchronize()
    launches = cuda_nms.LAUNCHES
    expected = 2 * rounds * n_batches + n_single + 1
    log(f"serve: nms_suppress launched {launches} times in the main path "
        f"(expected {expected}: one per graph call)")
    if launches != expected:
        raise AssertionError("the serving path did not go through the kernel")
    n_dets = [d for _, d in runs_host + runs_dev] + [
        sum(len(r["boxes"]) for r in singles + api)]
    if min(n_dets) == 0:
        raise AssertionError("serving returned no detections")
    for r in singles + api:
        b = r["boxes"]
        if not (np.isfinite(b).all() and b.shape[1] == 4 and (b[:, 2] <= 639).all()
                and (b[:, 3] <= 479).all()):
            raise AssertionError("single-frame boxes not finite / not in the frame")
    ips_host = [r for r, _ in runs_host]
    ips_dev = [r for r, _ in runs_dev]
    single_ms = np.array([r["speed"]["total_ms"] for r in singles])
    log(f"serve: img/s at b{BATCH} from host uint8 batches (upload included), "
        f"{rounds} runs of {n_batches} batches: "
        f"{', '.join(f'{v:.1f}' for v in ips_host)} [{card}]")
    log(f"serve: img/s at b{BATCH} from device-resident batches, {rounds} runs of "
        f"{n_batches} batches: {', '.join(f'{v:.1f}' for v in ips_dev)} [{card}]")
    log(f"serve: infer_image per 480x640 frame (host letterbox included), "
        f"n={n_single}: median {np.median(single_ms):.2f} ms, "
        f"p90 {np.percentile(single_ms, 90):.2f} ms [{card}]")

    # per-stage device time at b128 (outside the launch-count window)
    x = dev[0]
    with torch.inference_mode():
        stages = {"forward": cuda_ms(lambda: pred.forward(x), 10)}
        outs = pred.forward(x)
        stages["decode+scores"] = cuda_ms(lambda: _decode_scores(outs), 10)
        box, scores, classes = _decode_scores(outs)
        sel = lambda: select_candidates(box, scores, classes, conf_th=kw["conf"],
                                        k=PRE_NMS_TOPK, class_aware=True)
        stages["topk+gather"] = cuda_ms(sel, 10)
        top, idx, boxes_k, cls_k, valid, shifted = sel()
        shifted = shifted.contiguous()
        stages["suppression"] = cuda_ms(
            lambda: cuda_nms.greedy_keep(shifted, valid, kw["iou"]), 20)
        keep = cuda_nms.greedy_keep(shifted, valid, kw["iou"])
        stages["final top-k"] = cuda_ms(
            lambda: finalize_detections(keep, top, idx, boxes_k, cls_k,
                                        max_det=kw["max_det"]), 10)
        stages["whole graph"] = cuda_ms(
            lambda: pred.postprocess(pred.forward(x), IMG, **kw), 10)
        # the stage split must reproduce the composed path
        ref = batched_nms(box, scores, classes, iou_th=kw["iou"], conf_th=kw["conf"],
                          max_det=kw["max_det"], pre_nms_topk=PRE_NMS_TOPK)
        fin = finalize_detections(keep, top, idx, boxes_k, cls_k, max_det=kw["max_det"])
        if not all(torch.equal(a, b) for a, b in zip(ref, fin)):
            raise AssertionError("stage split disagrees with batched_nms")
    for name, ms in stages.items():
        log(f"stage {name}: {ms:.3f} ms per b{BATCH} batch [{card}]")
    log(f"stage whole graph: {BATCH / stages['whole graph'] * 1e3:.1f} img/s "
        f"device-only [{card}]")
    return {"launches": launches, "img_s_host": ips_host, "img_s_device_stream": ips_dev,
            "infer_image_ms": single_ms.tolist(), "stages_ms": stages,
            "profile": profile_graph(pred, x, card, kw)}


def profile_graph(pred, x, card: str, kw, iters: int = 3, rows: int = 10):
    """torch.profiler over `iters` device-resident b128 graph calls: device
    busy share of the window and the `rows` kernels that take the most time."""
    from torch.profiler import ProfilerActivity, profile
    with torch.inference_mode():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(iters):
                pred.postprocess(pred.forward(x), IMG, **kw)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) is not None
              and str(e.device_type).endswith("CUDA")]
    dev_ms = sum(e.self_device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:rows]
    log(f"profile: {iters} graph calls, device busy {dev_ms:.3f} ms of "
        f"{wall_ms:.3f} ms wall ({100 * dev_ms / wall_ms:.1f}% busy; profiler on) [{card}]")
    rows = []
    for e in top:
        ms = e.self_device_time_total / 1e3 / iters
        rows.append({"kernel": e.key[:120], "ms_per_call": ms, "count": e.count // iters})
        log(f"  {ms:8.3f} ms/call  x{e.count // iters:<4d} {e.key[:100]}")
    return {"busy_ms": dev_ms, "wall_ms": wall_ms, "iters": iters, "top": rows}


def zoo_configs():
    """(path relative to the repo, config) of every detection config under
    configs/, read with the port's own YAML reader, at 3 classes."""
    out = []
    for sub in MODEL_DIRS:
        for path in sorted(glob.glob(os.path.join(ROOT, "configs", sub, "*.yaml"))):
            cfg = read_yaml(path)
            if "model" in cfg and not cfg["model"].get("with_masks"):
                cfg["model"]["num_classes"] = 3
                out.append((os.path.relpath(path, ROOT), cfg))
    if sorted(rel for rel, _ in out) != sorted(ZOO_PARAMS):
        raise AssertionError(f"detection configs {[r for r, _ in out]} "
                             f"!= {sorted(ZOO_PARAMS)}")
    return out


@torch.no_grad()
def calibrate_batchnorm(model: torch.nn.Module, x: torch.Tensor,
                        skip: str = "") -> torch.nn.Module:
    """Set every BatchNorm's running mean and variance (but those under the
    submodule `skip`) to the statistics of its input over one forward of `x`
    (layer by layer, in order), as training would. A seeded model otherwise
    fades to nothing through depth: its convs shrink each signal
    (U(+-1/sqrt(fan_in)) has gain 1/sqrt(3)) and identity BatchNorm does not
    restore it, so every level output would be its head bias."""
    def set_stats(mod, args):
        h = args[0].float()
        mod.running_mean.copy_(h.mean((0, 2, 3)))
        mod.running_var.copy_(h.var((0, 2, 3), unbiased=False))

    hooks = [m.register_forward_pre_hook(set_stats) for name, m in model.named_modules()
             if isinstance(m, BatchNorm) and not (skip and name.startswith(skip + "."))]
    try:
        model(x)
    finally:
        for h in hooks:
            h.remove()
    return model


def _zoo_model(cfg, images_u8: torch.Tensor):
    """Seeded full-size model (seed 0) whose BatchNorm statistics come from
    one fp32 forward of `images_u8` on the card, so that activations keep
    their scale through depth (see calibrate_batchnorm)."""
    model = init_weights(build_model_from_config(cfg), seed=0).cuda().eval()
    calibrate_batchnorm(model, normalize_images(images_u8.permute(0, 3, 1, 2)))
    return model.cpu()


def zoo_fp32(model, meta, img: torch.Tensor, kw):
    """One image at 640, TF32 off: the card's fp32 level maps against the
    CPU's, and each against an fp64 forward on the card (see ZOO_FP32_FACTOR
    and ZOO_FP32_RTOL; on the CPU that forward took most of the zoo's
    time); batched_nms of
    the CPU's decoded outputs on the card (kernel) and the CPU (plain
    version) bit-exact."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        t0 = time.perf_counter()
        triple = (model, model.state_dict(), meta)
        gpu = Predictor(triple, device="cuda", dtype=torch.float32)
        cpu = Predictor(triple, device="cpu", dtype=torch.float32)
        card64 = Predictor(triple, device="cuda", dtype=torch.float64)
        with torch.inference_mode():
            og = [o.cpu() for o in gpu.forward(img.cuda())]
            t1 = time.perf_counter()
            oc = cpu.forward(img)
            t_cpu = time.perf_counter() - t1
            t1 = time.perf_counter()
            o64 = [o.cpu() for o in card64.forward(img.cuda())]
            t_fp64 = time.perf_counter() - t1

            def max_err(outs):
                return max(float((a.double() - b).abs().max()) for a, b in zip(outs, o64))
            err_card, err_cpu = max_err(og), max_err(oc)
            err = max(float((a - b).abs().max()) for a, b in zip(og, oc))
            scale = max(float(o.abs().max()) for o in o64)
            dec = _decode_scores(oc)
            got = batched_nms(*(t.cuda() for t in dec), **kw)
            want = batched_nms(*dec, **kw)
            names = ("boxes", "scores", "classes", "valid", "idx")
            for name, a, b in zip(names, got, want):
                if not torch.equal(a.cpu(), b):
                    raise AssertionError(f"zoo fp32 batched_nms {name}: card != CPU")
        if not (err_card <= ZOO_FP32_FACTOR * err_cpu and err <= ZOO_FP32_RTOL * scale):
            raise AssertionError(f"zoo fp32 forward: card vs CPU {err}, card vs fp64 "
                                 f"{err_card}, CPU fp32 vs fp64 {err_cpu} (scale {scale})")
        return {"fwd_max_abs_err": err, "card_vs_fp64": err_card, "cpu_vs_fp64": err_cpu,
                "scale": scale, "anchors": int(dec[0].shape[1]),
                "nms_kept": int(want[3].sum()), "cpu_forward_s": t_cpu,
                "fp64_forward_s": t_fp64, "s": time.perf_counter() - t0}
    finally:
        torch.backends.cudnn.allow_tf32 = True


def zoo_serve(model, meta, dev, frame, card: str, kw):
    """bf16 channels_last Predictor, device-resident b128 batches: warmup,
    then ZOO_RUNS runs of ZOO_BATCHES batches and one YoloLite.predict frame
    with the kernel's launches counted; forward ms and the top kernels."""
    pred = Predictor((model, model.state_dict(), meta), device="cuda", dtype=torch.bfloat16)
    pred.warmup(**kw)
    list(pred.infer_batched_stream(dev[:1], prepared=True, **kw))
    torch.cuda.synchronize()

    def stream():
        t0 = time.perf_counter()
        dets = sum(len(r["boxes"]) for out in pred.infer_batched_stream(
            (dev[i % len(dev)] for i in range(ZOO_BATCHES)), prepared=True, depth=2, **kw)
            for r in out)
        return ZOO_BATCHES * BATCH / (time.perf_counter() - t0), dets

    cuda_nms.LAUNCHES = 0
    runs = [stream() for _ in range(ZOO_RUNS)]
    api = YoloLite((model, model.state_dict(), meta)).predict(frame, **kw)[0]
    torch.cuda.synchronize()
    launches = cuda_nms.LAUNCHES
    expected = ZOO_RUNS * ZOO_BATCHES + 1
    if launches != expected:
        raise AssertionError(f"zoo: nms_suppress launched {launches} times, "
                             f"expected {expected} (one per graph call)")
    b = api["boxes"]
    if min(d for _, d in runs) == 0 or len(b) == 0:
        raise AssertionError("zoo: serving returned no detections")
    if not (np.isfinite(b).all() and (b[:, 2] <= frame.shape[1] - 1).all()
            and (b[:, 3] <= frame.shape[0] - 1).all()):
        raise AssertionError("zoo: predict boxes not finite / not in the frame")
    x = dev[0]
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: pred.forward(x), 5, 1)
    prof = profile_graph(pred, x, card, kw, iters=1, rows=3)
    return {"launches": launches, "img_s": [r for r, _ in runs],
            "dets": [d for _, d in runs], "forward_ms": fwd_ms,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9, "profile": prof}


def phase_zoo(card: str):
    rng = np.random.RandomState(3)
    dev = [torch.from_numpy((rng.rand(BATCH, IMG, IMG, 3) * 255).astype(np.uint8)).cuda()
           for _ in range(2)]
    calib = dev[0][:2].clone()
    img = torch.from_numpy((rng.rand(1, IMG, IMG, 3) * 255).astype(np.uint8))
    frame = (rng.rand(480, 640, 3) * 255).astype(np.uint8)
    meta = {"img_size": IMG, "names": ["c0", "c1", "c2"]}
    kw_nms = dict(iou_th=0.45, conf_th=0.001, max_det=300, pre_nms_topk=PRE_NMS_TOPK)
    kw = dict(conf=0.001, iou=0.45, max_det=300)
    rows = {}
    for rel, cfg in zoo_configs():
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        model = _zoo_model(cfg, calib)
        params = count_params(model)
        if params != ZOO_PARAMS[rel]:
            raise AssertionError(f"{rel}: {params} params, JAX has {ZOO_PARAMS[rel]}")
        fp32 = zoo_fp32(model, meta, img, kw_nms)
        serve = zoo_serve(model, meta, dev, frame, card, kw)
        top = serve["profile"]["top"][0]
        rows[rel] = {"backbone": cfg["model"]["backbone"], "params": params,
                     "fp32": fp32, **serve, "s": time.perf_counter() - t0}
        log(f"zoo {rel} ({cfg['model']['backbone']}): {params} params; fp32 card vs CPU "
            f"max abs err {fp32['fwd_max_abs_err']:.3e} over |x| <= {fp32['scale']:.2f} "
            f"(tolerance {ZOO_FP32_RTOL:g} x scale); "
            f"against fp64: card {fp32['card_vs_fp64']:.3e}, CPU fp32 "
            f"{fp32['cpu_vs_fp64']:.3e} (card must stay within {ZOO_FP32_FACTOR:g}x); "
            f"batched_nms over {fp32['anchors']} anchors bit-exact ({fp32['nms_kept']} "
            f"kept); CPU fp32 forward {fp32['cpu_forward_s']:.2f} s, card fp64 "
            f"{fp32['fp64_forward_s']:.2f} s, the check {fp32['s']:.2f} s")
        ips = ", ".join(f"{v:.1f}" for v in serve["img_s"])
        log(f"zoo {rel}: bf16 b{BATCH} img/s {ips}"
            f"; forward {serve['forward_ms']:.3f} ms; nms_suppress launches "
            f"{serve['launches']}; peak {serve['peak_gb']:.2f} GB; top kernel "
            f"{top['ms_per_call']:.3f} ms {top['kernel'][:80]}; "
            f"{rows[rel]['s']:.1f} s [{card}]")
        del model
        torch.cuda.empty_cache()
    return rows


def make_synth_set(root: str, n_train: int = 32, n_val: int = 8, w: int = 640,
                   h: int = 480, n_cls: int = 3, seed: int = 0, fmt: str = "png") -> str:
    """A learnable detection set from a seed: 1-4 coloured rectangles (one
    colour per class) on dark noise, PNG images (or, with fmt="jpg" or "tif",
    the same pixels as baseline JPEGs of `write_jpeg` or TIFFs of
    `write_tiff`), YOLO txt labels and a data.yaml. Returns the data.yaml
    path."""
    rng = np.random.RandomState(seed)
    colors = [(220, 30, 30), (30, 220, 30), (30, 30, 220)]
    for split, n in (("train", n_train), ("valid", n_val)):
        os.makedirs(os.path.join(root, split, "images"), exist_ok=True)
        os.makedirs(os.path.join(root, split, "labels"), exist_ok=True)
        for i in range(n):
            canvas = (rng.rand(h, w, 3) * 40).astype(np.uint8)
            lines = []
            for _ in range(rng.randint(1, 5)):
                cls = rng.randint(0, n_cls)
                bw = rng.randint(w // 16, w // 3)
                bh = rng.randint(h // 16, h // 3)
                x1, y1 = rng.randint(0, w - bw), rng.randint(0, h - bh)
                canvas[y1:y1 + bh, x1:x1 + bw] = colors[cls]
                lines.append(f"{cls} {(x1 + bw / 2) / w:.6f} {(y1 + bh / 2) / h:.6f} "
                             f"{bw / w:.6f} {bh / h:.6f}")
            writer = {"jpg": write_jpeg, "tif": write_tiff}.get(fmt, write_png)
            writer(os.path.join(root, split, "images", f"{i:04d}.{fmt}"), canvas)
            with open(os.path.join(root, split, "labels", f"{i:04d}.txt"), "w") as f:
                f.write("\n".join(lines) + "\n")
    data_yaml = os.path.join(root, "data.yaml")
    with open(data_yaml, "w") as f:
        f.write(f"train: {root}/train/images\nval: {root}/valid/images\nnc: {n_cls}\n"
                f"names: [{', '.join(f'c{i}' for i in range(n_cls))}]\n")
    return data_yaml


SEG_SHAPES = ("rect", "tri", "ell")


def seg_polygon(rng, kind: str, w: int, h: int):
    """Integer vertices of one shape in a w x h frame: a rectangle, a
    triangle or a non-convex L."""
    bw, bh = rng.randint(w // 10, w // 3), rng.randint(h // 10, h // 3)
    x1, y1 = rng.randint(0, w - bw), rng.randint(0, h - bh)
    x2, y2 = x1 + bw, y1 + bh
    if kind == "rect":
        return [(x1, y1), (x2, y1), (x2, y2), (x1, y2)]
    if kind == "tri":
        return [(x1, y2), (x2, y2), (x1 + bw // 2, y1)]
    xm, ym = x1 + bw // 3, y1 + 2 * bh // 3
    return [(x1, y1), (xm, y1), (xm, ym), (x2, ym), (x2, y2), (x1, y2)]


def make_seg_set(root: str, n_train: int = 32, n_val: int = 8, w: int = 640,
                 h: int = 480, seed: int = 0) -> str:
    """A learnable instance-segmentation set from a seed: 1-4 filled shapes
    (a rectangle, a triangle or a non-convex L; one colour per class) on
    dark noise, PNG images, YOLO polygon labels and a data.yaml. Returns the
    data.yaml path."""
    rng = np.random.RandomState(seed)
    colors = [(220, 30, 30), (30, 220, 30), (30, 30, 220)]
    for split, n in (("train", n_train), ("valid", n_val)):
        os.makedirs(os.path.join(root, split, "images"), exist_ok=True)
        os.makedirs(os.path.join(root, split, "labels"), exist_ok=True)
        for i in range(n):
            canvas = (rng.rand(h, w, 3) * 40).astype(np.uint8)
            lines = []
            for _ in range(rng.randint(1, 5)):
                cls = rng.randint(0, len(SEG_SHAPES))
                poly = seg_polygon(rng, SEG_SHAPES[cls], w, h)
                fill = np.zeros((h, w), np.uint8)
                imgops.fill_poly(fill, np.asarray(poly, np.int32), 1)
                canvas[fill > 0] = colors[cls]
                lines.append(f"{cls} " + " ".join(f"{x / w:.6f} {y / h:.6f}" for x, y in poly))
            write_png(os.path.join(root, split, "images", f"{i:04d}.png"), canvas)
            with open(os.path.join(root, split, "labels", f"{i:04d}.txt"), "w") as f:
                f.write("\n".join(lines) + "\n")
    data_yaml = os.path.join(root, "data.yaml")
    with open(data_yaml, "w") as f:
        f.write(f"train: {root}/train/images\nval: {root}/valid/images\n"
                f"nc: {len(SEG_SHAPES)}\nnames: [{', '.join(SEG_SHAPES)}]\n")
    return data_yaml


def _edge_n_train_config(data_yaml: str, amp: bool):
    cfg = load_configs(os.path.join(ROOT, "configs", "models", "edge_n.yaml"),
                       os.path.join(ROOT, "configs", "train", "standard_train.yaml"),
                       data_yaml, make_run_dir=False)
    cfg["training"].update(augment=False, amp=amp, img_size=IMG, batch_size=8)
    return cfg


def _seeded_flax_edge_n(cfg):
    """flax-layout variables of edge_n: seed-0 heads, the bundled backbone."""
    model = init_weights(build_model_from_config(cfg), 0)
    sd, _ = load_checkpoint(BACKBONE_CKPT)
    load_flax(model.backbone, sd["params"], sd["batch_stats"])
    return to_flax(model)


def _first_batch(cfg, n: int = 8):
    ds = YoloDataset(cfg["dataset"]["train_images"], cfg["dataset"]["train_labels"],
                     img_size=IMG, is_train=True, augment=False,
                     max_boxes=int(cfg["training"]["max_boxes"]))
    return collate([ds.get(i) for i in range(n)])


def _model_grads(cfg, params, stats, images_u8, upstream, device, dtype):
    """Parameter gradients of edge_n's train-mode forward (BatchNorm on batch
    statistics) for a fixed upstream gradient of the level outputs."""
    model = load_flax(build_model_from_config(cfg), params, stats).to(device, dtype).train()
    x = normalize_images(torch.from_numpy(images_u8).to(device).permute(0, 3, 1, 2))
    if device == "cuda":
        model.to(memory_format=torch.channels_last)
    outs = model(x.to(dtype))
    grads = torch.autograd.grad(outs, list(model.parameters()),
                                grad_outputs=[u.to(device, dtype) for u in upstream],
                                allow_unused=True, materialize_grads=True)
    return [g.detach().cpu().double() for g in grads]


def train_fp32_parity(data_yaml: str, card: str):
    """One fp32 train step (TF32 off) on the card and on the CPU from the
    same weights and batch: equal assignment, losses and updated parameters
    within TRAIN_FP32_*; the loss's backward on equal outputs equal to
    rounding; the model's backward held against a CPU fp64 one (see
    TRAIN_FP32_FACTOR)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cfg = _edge_n_train_config(data_yaml, amp=False)
        params, stats = _seeded_flax_edge_n(cfg)
        batch = _first_batch(cfg)
        lr_vec = None
        out = {}
        for dev in ("cuda", "cpu"):
            t0 = time.perf_counter()
            trainer = Trainer(build_model_from_config(cfg), cfg, total_updates=8, device=dev)
            state = trainer.state_from_weights(params, stats)
            lr_vec = trainer.lr_vector(float(cfg["training"]["lr"]))
            b = trainer.put_batch(batch)
            total, m = trainer.forward_loss(state, b, return_assignment=True)
            grads = trainer.backward(state, total)
            trainer.apply(state, grads, lr_vec)
            out[dev] = {"total": float(total.detach()), **{k: m[k].detach().cpu() for k in m},
                        "params": [p.detach().cpu() for p in state.params],
                        "trainer": trainer, "batch": b, "s": time.perf_counter() - t0}
        g, c = out["cuda"], out["cpu"]
        pos = c["pos_mask"]
        matched_equal = (torch.equal(g["pos_mask"], pos)
                         and torch.equal(g["matched_gt"][pos], c["matched_gt"][pos]))
        loss_errs = {k: abs(float(g[k]) - float(c[k])) / max(abs(float(c[k])), 1e-12)
                     for k in ("total", "box", "obj", "cls")}
        loss_err = max(loss_errs.values())
        d_param = max(float((a - b).abs().max()) for a, b in zip(g["params"], c["params"]))
        lr_max = max(lr_vec)

        # the loss's backward on equal outputs: the CPU's train-mode outputs
        flat = lambda gs: torch.cat([x.reshape(-1).double().cpu() for x in gs])
        rel = lambda a, b: float((flat(a) - flat(b)).norm() / flat(b).norm())
        x_c = normalize_images(c["batch"]["image"].permute(0, 3, 1, 2))
        outs = [o.detach() for o in load_flax(build_model_from_config(cfg), params, stats)
                .train()(x_c)]
        upstream = {}
        for dev in ("cuda", "cpu"):
            o = [t.to(dev).requires_grad_(True) for t in outs]
            bt = out[dev]["batch"]
            total, _ = out[dev]["trainer"].loss(o, {k: bt[k] for k in ("boxes", "labels", "mask")},
                                                img_size=IMG)
            upstream[dev] = torch.autograd.grad(total, o)
        loss_grad_err = rel(upstream["cuda"], upstream["cpu"])
        # the model's backward from one upstream gradient, fp32 card and CPU
        # against the CPU in fp64
        up = upstream["cpu"]
        ref = _model_grads(cfg, params, stats, batch["image"], up, "cpu", torch.float64)
        err_card = rel(_model_grads(cfg, params, stats, batch["image"], up, "cuda",
                                    torch.float32), ref)
        err_cpu = rel(_model_grads(cfg, params, stats, batch["image"], up, "cpu",
                                   torch.float32), ref)
        log(f"train fp32 card vs CPU (TF32 off, b8 @640, M={batch['boxes'].shape[1]}): "
            f"assignment {'equal' if matched_equal else 'DIFFERS'} ({int(pos.sum())} positives); "
            f"loss rel err {', '.join(f'{k} {v:.3e}' for k, v in loss_errs.items())} "
            f"(tolerance {TRAIN_FP32_LOSS_RTOL:g}); loss backward on equal outputs rel L2 "
            f"{loss_grad_err:.3e} (tolerance {TRAIN_FP32_LOSS_GRAD_RTOL:g}); model backward "
            f"against CPU fp64, rel L2: card fp32 {err_card:.3e}, CPU fp32 {err_cpu:.3e} (card "
            f"within {TRAIN_FP32_FACTOR:g}x); updated params max abs diff {d_param:.3e} "
            f"(tolerance {2.1 * lr_max:.3e}); card {g['s']:.2f} s, CPU {c['s']:.2f} s [{card}]")
        if not (matched_equal and loss_err <= TRAIN_FP32_LOSS_RTOL
                and loss_grad_err <= TRAIN_FP32_LOSS_GRAD_RTOL
                and err_card <= TRAIN_FP32_FACTOR * err_cpu and d_param <= 2.1 * lr_max):
            raise AssertionError("train fp32 card vs CPU disagree")
        return {"assignment_equal": matched_equal, "positives": int(pos.sum()),
                "loss_rel_err": loss_errs, "loss_grad_rel_l2": loss_grad_err,
                "model_grad_rel_l2_vs_fp64": {"card_fp32": err_card, "cpu_fp32": err_cpu},
                "param_max_abs_diff": d_param, "card_s": g["s"], "cpu_s": c["s"]}
    finally:
        torch.backends.cudnn.allow_tf32 = True


def _events(n):
    return [torch.cuda.Event(enable_timing=True) for _ in range(n)]


def _step_profile(cfg, data_yaml: str, card: str, label: str, iters: int = 10):
    """The bf16 train step of `cfg` on batches from its own train loader (its
    augmentation settings): ms per step by CUDA events over `iters` steps,
    then the device busy share, launches per step and top kernels
    (torch.profiler, 3 steps). Returns the numbers and (trainer, state,
    device batches, lr)."""
    params, stats = _seeded_flax_edge_n(cfg)
    trainer = Trainer(build_model_from_config(cfg), cfg, total_updates=1000, device="cuda")
    state = trainer.state_from_weights(params, stats)
    tr = cfg["training"]
    ds = YoloDataset(cfg["dataset"]["train_images"], cfg["dataset"]["train_labels"],
                     img_size=IMG, is_train=True, augment=bool(tr["augment"]),
                     max_boxes=int(tr["max_boxes"]), task=_task(cfg), want_rles=False,
                     photometric=not bool(tr.get("device_augment", False)))
    loader = DataLoader(ds, 8, shuffle=True, num_workers=8)
    t0 = time.perf_counter()
    batches = list(loader)
    loader_ms = (time.perf_counter() - t0) * 1e3 / len(batches)
    dev = [trainer.put_batch(b) for b in batches]
    lr = trainer.lr_vector(1e-3)
    for i in range(3):
        trainer.train_step(state, dev[i % len(dev)], lr)
    torch.cuda.synchronize()
    s, e = _events(2)
    s.record()
    for i in range(iters):
        trainer.train_step(state, dev[i % len(dev)], lr)
    e.record()
    e.synchronize()
    step_ms = s.elapsed_time(e) / iters

    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(3):
            trainer.train_step(state, dev[i % len(dev)], lr)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [ev for ev in prof.key_averages()
              if getattr(ev, "device_type", None) is not None
              and str(ev.device_type).endswith("CUDA")]
    busy_ms = sum(ev.self_device_time_total for ev in events) / 1e3
    launches = sum(ev.count for ev in events) / 3
    top = [{"kernel": ev.key[:120], "ms_per_step": ev.self_device_time_total / 3e3,
            "count": ev.count // 3}
           for ev in sorted(events, key=lambda ev: -ev.self_device_time_total)[:10]]
    gt = float(np.mean([b["mask"].sum(1).mean() for b in batches]))
    log(f"{label}: step {step_ms:.3f} ms by CUDA events over {iters} steps "
        f"({8e3 / step_ms:.1f} img/s; M={int(tr['max_boxes'])}, {gt:.1f} GT boxes per image); "
        f"profile of 3 steps: device busy {busy_ms:.3f} of {wall_ms:.3f} ms wall "
        f"({100 * busy_ms / wall_ms:.1f}% busy; profiler on), {launches:.0f} kernel launches "
        f"per step; loader {loader_ms:.1f} ms per batch of 8 [{card}]")
    for row in top:
        log(f"  {row['ms_per_step']:8.3f} ms/step  x{row['count']:<4d} {row['kernel'][:100]}")
    numbers = {"step_ms": step_ms, "img_s": 8e3 / step_ms, "busy_ms": busy_ms,
               "wall_ms": wall_ms, "launches_per_step": launches, "top": top,
               "loader_ms_per_batch": loader_ms, "gt_per_image": gt,
               "max_boxes": int(tr["max_boxes"])}
    return numbers, (trainer, state, dev, lr)


def _task(cfg) -> str:
    return "segment" if cfg["model"].get("with_masks") else "detect"


def _step_split(trainer, state, dev, lr, iters: int):
    """Synced train steps split by CUDA events into forward+loss, backward
    and optimizer+EMA ms; also the host ms per synced step, the peak GB and
    the last step's loss metrics."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    split = np.zeros(3)
    t0 = time.perf_counter()
    for i in range(iters):
        e = _events(4)
        e[0].record()
        total, metrics = trainer.forward_loss(state, dev[i % len(dev)])
        e[1].record()
        grads = trainer.backward(state, total)
        e[2].record()
        trainer.apply(state, grads, lr)
        e[3].record()
        e[3].synchronize()
        split += [e[0].elapsed_time(e[1]), e[1].elapsed_time(e[2]), e[2].elapsed_time(e[3])]
    synced_ms = (time.perf_counter() - t0) * 1e3 / iters
    return (split / iters, synced_ms, torch.cuda.max_memory_allocated() / 1e9,
            {k: float(v.detach()) for k, v in metrics.items()})


def train_timing(data_yaml: str, card: str, tmp: str, iters: int = 10):
    """bf16 b8 train step on augmented batches (the recipe's default): step
    ms, device busy share and top kernels (`_step_profile`); the step split
    (forward+loss, backward, optimizer+EMA), one thread's ms per sample and
    PNG decode, eval_step, evaluate_model, peak memory."""
    cfg = _edge_n_train_config(data_yaml, amp=True)
    cfg["training"]["augment"] = True
    prof, (trainer, state, dev, lr) = _step_profile(cfg, data_yaml, card,
                                                    f"train step b8 bf16 @{IMG}, augment on", iters)
    mb = int(cfg["training"]["max_boxes"])
    ds = YoloDataset(cfg["dataset"]["train_images"], cfg["dataset"]["train_labels"],
                     img_size=IMG, is_train=True, augment=True, max_boxes=mb)
    t0 = time.perf_counter()
    for i in range(8):
        ds.get(i, np.random.RandomState(i))
    get_ms = (time.perf_counter() - t0) * 1e3 / 8
    t0 = time.perf_counter()
    for i in range(8):
        ds.load_image(i)
    decode_ms = (time.perf_counter() - t0) * 1e3 / 8
    split, synced_ms, peak_gb, _ = _step_split(trainer, state, dev, lr, iters)

    variables = trainer.ema_variables(state)
    val_ds = YoloDataset(cfg["dataset"]["val_images"], cfg["dataset"]["val_labels"],
                         img_size=IMG, is_train=False, augment=False, max_boxes=mb)
    val_loader = DataLoader(val_ds, 8, shuffle=False, drop_last=False)
    vb = trainer.put_batch(next(iter(val_loader)))
    eval_ms = {conf: cuda_ms(lambda: trainer.eval_step(variables, vb, conf_th=conf,
                                                       iou_th=0.65), 10)
               for conf in (0.1, 0.001)}
    t0 = time.perf_counter()
    evaluate_model(trainer, variables, val_loader, os.path.join(tmp, "eval"), 3, IMG,
                   ["c0", "c1", "c2"])
    evaluate_s = time.perf_counter() - t0
    log(f"train step split (events, synced each step: {synced_ms:.3f} ms host clock): "
        f"forward+loss {split[0]:.3f}, backward {split[1]:.3f}, optimizer+EMA "
        f"{split[2]:.3f} ms; peak {peak_gb:.2f} GB [{card}]")
    log(f"train host: one thread {get_ms:.2f} ms per augmented sample, of which PNG decode "
        f"{decode_ms:.2f} ms per image (a mosaic decodes 4, a cutmix 2) [{card}]")
    log(f"eval_step b8 @640: {eval_ms[0.1]:.3f} ms at conf 0.1, {eval_ms[0.001]:.3f} ms "
        f"at conf 0.001 (val loss + decode + NMS, k=1024); evaluate_model on the "
        f"{len(val_ds)} val images {evaluate_s:.2f} s (latency benches included) [{card}]")
    return dict(prof, split_ms=split.tolist(), synced_step_ms=synced_ms, peak_gb=peak_gb,
                get_ms_per_image=get_ms, decode_ms_per_image=decode_ms, eval_step_ms=eval_ms,
                evaluate_model_s=evaluate_s)


def _check_run_dir(log_dir: str, curves: bool = True) -> None:
    """A run's artifacts; `curves=False` for a run whose final evaluation
    may find no detection to draw P/R/F1 curves of."""
    want = ["merged_config.yaml", "metrics.csv", "last_metrics.json", "best_metrics.json",
            "eval_results.json", "confusion_stats.txt",
            "weights/best_model_state.ckpt", "weights/last_model_state.ckpt"]
    want += ["p_r_f1_curves.csv"] if curves else []
    missing = [w for w in want if not os.path.exists(os.path.join(log_dir, w))]
    if missing:
        raise AssertionError(f"train: missing artifacts {missing}")
    with open(os.path.join(log_dir, "metrics.csv")) as f:
        if f.readline().strip().split(",") != CSV_HEADER:
            raise AssertionError("train: metrics.csv header differs from CSV_HEADER")


class _ChunkEnd(Exception):
    """Raised after an epoch's checkpoints to end a training chunk."""


def train_chunk(epochs_done: int, **kw):
    """YoloLite.train stopped after `epochs_done` epochs of the configured
    run, as a time-limited chunk of tools/run_chunked_train.sh is killed: the
    taper and schedule stay those of the whole run. Returns the run's
    log_dir and its per-epoch train losses from metrics.csv."""
    real = train_loop._save_loss_curve

    def end_of_epoch(train_losses, *a):
        real(train_losses, *a)
        if len(train_losses) >= epochs_done:
            raise _ChunkEnd

    train_loop._save_loss_curve = end_of_epoch
    runs = kw.pop("run_dir")
    before = set(os.listdir(runs)) if os.path.isdir(runs) else set()
    try:
        YoloLite("edge_n", device="cuda").train(run_dir=runs, **kw)
        raise AssertionError("train chunk: the run did not stop")
    except _ChunkEnd:
        pass
    finally:
        train_loop._save_loss_curve = real
    new = sorted(set(os.listdir(runs)) - before - {"latest"}, key=int)
    log_dir = os.path.join(runs, new[-1])
    with open(os.path.join(log_dir, "metrics.csv")) as f:
        rows = f.read().strip().splitlines()[1:]
    return log_dir, [float(r.split(",")[CSV_HEADER.index("train_loss")]) for r in rows]


def phase_train(card: str, data: str, tmp: str):
    """edge_n trained at 640 b8 bf16 for 2 epochs through YoloLite.train with
    the recipe's host augmentation; launches of nms_suppress counted over
    the run."""
    runs = os.path.join(tmp, "runs")
    api = YoloLite("edge_n", device="cuda")
    torch.cuda.synchronize()
    cuda_nms.LAUNCHES = 0
    t0 = time.perf_counter()
    res = api.train(data=data, workers=8, run_dir=runs, **TRAIN_OVERRIDES)
    torch.cuda.synchronize()
    launches = cuda_nms.LAUNCHES
    train_s = time.perf_counter() - t0
    epoch_s = [float(r.split(",")[CSV_HEADER.index("elapsed_s")]) for r in
               open(os.path.join(res["log_dir"], "metrics.csv")).read().strip().splitlines()[1:]]
    val_batches = -(-VAL_N // TRAIN_OVERRIDES["batch_size"])
    expected = (TRAIN_OVERRIDES["epochs"] + 1) * val_batches
    hist = res["history"]
    log(f"train (augment on): {TRAIN_OVERRIDES['epochs']} epochs in {train_s:.1f} s (epoch "
        f"seconds {', '.join(f'{v:.2f}' for v in epoch_s)}, validation included); epoch "
        f"train loss {', '.join(f'{v:.4f}' for v in hist['train_loss'])}; val loss "
        f"{', '.join(f'{v:.4f}' for v in hist['val_loss'])}; final AP50 "
        f"{res['coco']['AP50']:.4f}; nms_suppress launched {launches} times "
        f"(expected {expected}: {val_batches} val batch x {TRAIN_OVERRIDES['epochs']} "
        f"epochs + {val_batches} in evaluate_model) [{card}]")
    if launches != expected:
        raise AssertionError("train: the validation path did not go through the kernel")
    if not all(np.isfinite(hist["step_loss"] + hist["val_loss"])):
        raise AssertionError(f"train: non-finite loss {hist}")
    # the train losses of the two epochs are not comparable (epoch 1 trains
    # on mosaics of four images, epoch 2 after the taper on single ones), so
    # the loss that must fall is the EMA model's on the unaugmented val set
    if not hist["val_loss"][1] < hist["val_loss"][0]:
        raise AssertionError("train: epoch 2's val loss is not below epoch 1's")
    _check_run_dir(res["log_dir"])
    frame = (np.random.RandomState(4).rand(480, 640, 3) * 255).astype(np.uint8)
    served = {}
    for name in ("best_model_state.ckpt", "last_model_state.ckpt"):
        pred = Predictor(os.path.join(res["log_dir"], "weights", name), device="cuda")
        b, sc, _ = pred.infer_image(frame, conf=0.001)
        if not (np.isfinite(b).all() and len(b) > 0):
            raise AssertionError(f"train: {name} serves no finite boxes")
        served[name] = len(b)
    n_api = len(api.predict(frame, conf=0.001)[0]["boxes"])
    log(f"train: best_model_state / last checkpoints reload into the Predictor and serve "
        f"{served} boxes; YoloLite.predict on the best {n_api}")

    # exact resume under augmentation: the same 2-epoch run stopped after
    # epoch 1 (the taper stays the whole run's), then epoch 2 from its full
    # state, and as a control from its EMA weights alone (fresh EMA/optimizer)
    log1, chunk1_loss = train_chunk(1, data=data, workers=8, run_dir=runs, **TRAIN_OVERRIDES)
    chunk2 = YoloLite("edge_n", device="cuda").train(
        data=data, workers=8, run_dir=runs, **dict(
            TRAIN_OVERRIDES, resume=os.path.join(log1, "weights", "last_model_state.ckpt"),
            start_epoch=1))
    control = YoloLite("edge_n", device="cuda").train(
        data=data, workers=8, run_dir=runs, **dict(
            TRAIN_OVERRIDES, resume=os.path.join(log1, "weights", "best_model_state.ckpt"),
            start_epoch=1))
    straight = hist["train_loss"][1]
    resumed = chunk2["history"]["train_loss"][0]
    weights_only = control["history"]["train_loss"][0]
    rel = abs(resumed - straight) / abs(straight)
    log(f"train resume (augment on): epoch-2 train loss straight {straight:.6f}, resumed "
        f"from epoch 1's full state {resumed:.6f} (rel diff {rel:.2e}, tolerance "
        f"{RESUME_RTOL:g}); weights-only resume (fresh EMA/optimizer) "
        f"{weights_only:.6f} (rel diff {abs(weights_only - straight) / straight:.2e}); "
        f"epoch-1 loss straight {hist['train_loss'][0]:.6f}, chunk {chunk1_loss[0]:.6f}")
    if rel > RESUME_RTOL:
        raise AssertionError("train: exact resume does not reproduce epoch 2")
    fp32 = train_fp32_parity(data, card)
    timing = train_timing(data, card, tmp)
    return {"launches": launches, "train_s": train_s, "epoch_s": epoch_s, "history": hist,
            "coco": res["coco"], "ms_per_img": res["ms_per_img"],
            "ms_per_img_cpu": res["ms_per_img_cpu"], "served": served,
            "resume": {"straight": straight, "resumed": resumed, "rel": rel,
                       "weights_only": weights_only, "chunk1_epoch1": chunk1_loss[0]},
            "fp32": fp32, "timing": timing}


# --------------------------------------------------------------------------- #
def _instrument_host_aug():
    """Wrap every branch of host augmentation with a call counter and timer
    (thread-safe). Returns (stats {name: [calls, seconds]}, undo)."""
    import threading
    lock = threading.Lock()
    stats = {}

    def wrap(fn, name):
        stats[name] = [0, 0.0]

        def counted(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            with lock:
                stats[name][0] += 1
                stats[name][1] += time.perf_counter() - t0
            return out
        return counted

    saved = [(host_aug, n, getattr(host_aug, n)) for n in AUG_FUNCS + ("COLOR_OPS",)]
    saved += [(YoloDataset, n, getattr(YoloDataset, n)) for n in AUG_MIXES]
    for mod, name, fn in saved:
        if name == "COLOR_OPS":
            setattr(mod, name, tuple(wrap(f, f.__name__) for f in fn))
        else:
            setattr(mod, name, wrap(fn, name))

    def undo():
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    return stats, undo


def _aug_samples(ds, seed0, n, pool=None):
    draw = lambda i: ds.get(i % len(ds), np.random.RandomState(seed0 + i))  # noqa: E731
    return list(pool.map(draw, range(n))) if pool else [draw(i) for i in range(n)]


def _same_samples(a, b) -> bool:
    return all(all(np.array_equal(x[k], y[k]) for k in x) for x, y in zip(a, b))


def _loader_epoch_ms(ds) -> float:
    """ms per batch of 8 of one shuffled epoch, 8 loader threads."""
    loader = DataLoader(ds, 8, shuffle=True, seed=0, num_workers=8)
    t0 = time.perf_counter()
    n = sum(1 for _ in loader)
    return (time.perf_counter() - t0) * 1e3 / n


def phase_augment(card: str, data: str):
    """Host augmentation on the card's machine (numpy, no cv2) at 640x480 ->
    640: every branch fires, the same seeds give the same samples on a second
    pass and on 8 threads, host ms per op and per preset, and the loader's
    ms per batch of 8 with augmentation on and off."""
    from concurrent.futures import ThreadPoolExecutor
    cfg = read_yaml(data)
    root = os.path.dirname(data)
    imgs, labels = cfg["train"], os.path.join(root, "train", "labels")
    stats, undo = _instrument_host_aug()
    out = {"per_preset_ms": {}}
    try:
        for preset, seed0 in AUG_SEEDS.items():
            # decoded images cached: the numbers are augmentation + letterbox
            ds = YoloDataset(imgs, labels, img_size=IMG, is_train=True, augment=True,
                             aug_preset=preset, cache_images=True)
            for i in range(len(ds)):
                ds.load_image(i)
            t0 = time.perf_counter()
            first = _aug_samples(ds, seed0, AUG_SAMPLES)
            out["per_preset_ms"][preset] = (time.perf_counter() - t0) * 1e3 / AUG_SAMPLES
            with ThreadPoolExecutor(8) as pool:        # a second pass, on 8 threads
                again = _aug_samples(ds, seed0, AUG_SAMPLES, pool)
            if not _same_samples(first, again):
                raise AssertionError(f"augment {preset}: the same seeds gave other samples")
            for smp in first:
                b = smp["boxes"][smp["mask"]]
                if not (smp["image"].shape == (IMG, IMG, 3) and smp["image"].dtype == np.uint8
                        and np.isfinite(b).all() and (b >= 0).all() and (b <= IMG).all()
                        and (b[:, 2:] > b[:, :2]).all()
                        and ((smp["labels"][smp["mask"]] >= 0)
                             & (smp["labels"][smp["mask"]] < 3)).all()):
                    raise AssertionError(f"augment {preset}: a malformed sample")
            out[f"{preset}_boxes_per_sample"] = float(np.mean([s["mask"].sum() for s in first]))
    finally:
        undo()
    missing = [n for n, (calls, _) in stats.items() if calls == 0]
    # two passes per preset: counts and times over both
    out["ops"] = {n: {"calls": c, "ms": 1e3 * t / max(c, 1)} for n, (c, t) in stats.items()}
    log(f"augment: {AUG_SAMPLES} samples per preset (base, strong) at 640x480 -> {IMG}, "
        f"decoded images cached: base {out['per_preset_ms']['base']:.2f} ms, strong "
        f"{out['per_preset_ms']['strong']:.2f} ms per sample (one thread); identical on a "
        f"second pass on 8 threads [{card}]")
    log("augment host ms per call (calls over 2 passes of both presets): " + ", ".join(
        f"{n} {v['ms']:.2f} (x{v['calls']})" for n, v in sorted(out["ops"].items())))
    if missing:
        raise AssertionError(f"augment: branches that never fired: {missing}")
    # the train loader on the same images, augmentation off and on in turns
    on = YoloDataset(imgs, labels, img_size=IMG, is_train=True, augment=True)
    off = YoloDataset(imgs, labels, img_size=IMG, is_train=True, augment=False)
    ms = {"off": [], "on": []}
    for name, ds in (("off", off), ("on", on), ("on", on), ("off", off)):
        ms[name].append(_loader_epoch_ms(ds))
    out["loader_ms_per_batch"] = {k: float(np.mean(v)) for k, v in ms.items()}
    out["loader_runs_ms"] = ms
    log(f"augment loader: {out['loader_ms_per_batch']['on']:.1f} ms per batch of 8 with "
        f"augmentation, {out['loader_ms_per_batch']['off']:.1f} ms without (8 threads, PNG "
        f"decode included; runs off/on/on/off: {ms['off'][0]:.1f}/{ms['on'][0]:.1f}/"
        f"{ms['on'][1]:.1f}/{ms['off'][1]:.1f}) [{card}]")
    return out


def phase_device_augment(card: str, data: str, tmp: str):
    """Photometric augmentation on the card: the apply step on equal draws
    card vs CPU (within 1 level), its time at b8 and b64, and one epoch of
    edge_n at b8 with hardsynth_device_aug.yaml's device_augment."""
    cfg = read_yaml(data)
    val = YoloDataset(cfg["val"], os.path.join(os.path.dirname(data), "valid", "labels"),
                      img_size=IMG, is_train=False, augment=False)
    base = torch.from_numpy(collate([val.get(i) for i in range(8)])["image"])
    # card vs CPU on equal draws (every image coloured and noised or blurred)
    params = dev_aug.draw(base.shape, torch.Generator().manual_seed(0), 1.0, 1.0)
    want = dev_aug.apply(base, params)
    got = dev_aug.apply(base.cuda(), {k: v.cuda() for k, v in params.items()}).cpu()
    d = (got.int() - want.int()).abs()
    out = {"max_diff": int(d.max()), "share_differ": float((d > 0).float().mean()),
           "apply_ms": {}, "draw_apply_ms": {}, "bound_ms": {}}
    log(f"device_augment b8 @{IMG} (p_color = p_noise = 1): apply card vs CPU on equal draws, "
        f"max diff {out['max_diff']} level(s) on {out['share_differ']:.2e} of the values "
        f"(tolerance 1)")
    if out["max_diff"] > 1:
        raise AssertionError("device_augment: card and CPU differ by more than 1 level")
    for b in DEVAUG_BATCHES:
        x = base.cuda().repeat(b // 8, 1, 1, 1)
        gen = torch.Generator(device=x.device).manual_seed(b)
        p = dev_aug.draw(x.shape, gen, 0.4, 0.15, x.device)
        out["apply_ms"][b] = cuda_ms(lambda: dev_aug.apply(x, p), 20)
        out["draw_apply_ms"][b] = cuda_ms(lambda: dev_aug.photometric_augment(x, gen), 20)
        # uint8 images in and out, the fp32 noise in
        out["bound_ms"][b] = 6 * x.numel() / PEAK_BYTES_S * 1e3
        log(f"device_augment b{b} @{IMG}: apply {out['apply_ms'][b]:.3f} ms, draw+apply "
            f"{out['draw_apply_ms'][b]:.3f} ms, bytes bound {out['bound_ms'][b]:.4f} ms "
            f"[{card}]")
        del x, p
        torch.cuda.empty_cache()
    # one epoch as hardsynth_device_aug.yaml writes it, at the train phase's b8
    torch.cuda.synchronize()
    cuda_nms.LAUNCHES = 0
    t0 = time.perf_counter()
    res = YoloLite("edge_n", device="cuda").train(
        data=data, epochs=1, batch_size=8, img_size=IMG, workers=8, data_parallel=1,
        run_dir=os.path.join(tmp, "runs_devaug"), pretrained_backbone=BACKBONE_CKPT,
        train_yaml=os.path.join(ROOT, "configs", "train", "hardsynth_device_aug.yaml"))
    torch.cuda.synchronize()
    launches = cuda_nms.LAUNCHES
    out["train_s"] = time.perf_counter() - t0
    hist = res["history"]
    if not np.isfinite(hist["step_loss"]).all():
        raise AssertionError(f"device_augment: non-finite loss {hist}")
    if launches != 2:
        raise AssertionError(f"device_augment: {launches} nms_suppress launches, expected 2")
    out["step_loss"] = hist["step_loss"]
    out["nms_launches"] = launches
    # the step itself: device_augment on, geometry-only host batches
    tcfg = load_configs(os.path.join(ROOT, "configs", "models", "edge_n.yaml"),
                        os.path.join(ROOT, "configs", "train", "hardsynth_device_aug.yaml"),
                        data, make_run_dir=False)
    tcfg["training"].update(batch_size=8, img_size=IMG)
    out["step"] = _step_profile(tcfg, data, card, f"train step b8 bf16 @{IMG}, device_augment")[0]
    log(f"device_augment: 1 epoch of edge_n b8 by hardsynth_device_aug.yaml in "
        f"{out['train_s']:.1f} s, step losses "
        f"{', '.join(f'{v:.3f}' for v in hist['step_loss'])}, nms_suppress launched "
        f"{launches} times (1 val batch + 1 in evaluate_model) [{card}]")
    return out


# --------------------------------------------------------------------------- #
def _seg_config(rel: str):
    cfg = read_yaml(os.path.join(ROOT, rel))
    cfg["model"]["num_classes"] = 3
    cfg["training"] = {"img_size": IMG}
    return cfg


def _seg_model(rel: str, cfg, calib: torch.Tensor):
    """Seed-0 weights with BatchNorm statistics from one fp32 forward of
    `calib` (calibrate_batchnorm), so that prototypes and coefficients keep
    their scale (an uncalibrated seeded ProtoNet's prototypes are ~1e-2, and
    every mask probability sits at 0.5); edge_n_seg keeps the bundled
    MobileNetV4 backbone and its statistics."""
    if cfg["model"]["backbone"] == EDGE_N["model"]["backbone"]:
        model = init_weights(build_model_from_config(cfg), 0)
        sd, _ = load_checkpoint(BACKBONE_CKPT)
        load_flax(model.backbone, sd["params"], sd["batch_stats"])
        model = model.cuda().eval()
        calibrate_batchnorm(model, normalize_images(calib.permute(0, 3, 1, 2)),
                            skip="backbone")
        model = model.cpu()
    else:
        model = _zoo_model(cfg, calib)
    if count_params(model) != SEG_PARAMS[rel]:
        raise AssertionError(f"{rel}: {count_params(model)} params, JAX has {SEG_PARAMS[rel]}")
    return model


def _seg_decode(outs):
    d = decode_anchorfree([o.float() for o in outs], IMG, num_classes=3)
    scores, classes = yolo_scores(d["obj"][..., 0], d["cls"])
    return d, scores, classes


def _paired_mask_share(got, want, box_tol, score_tol):
    """Detections matched one to one (class, box, score) and the share of
    frame-mask pixels that differ over the matched pairs."""
    diff = pixels = matched = 0
    for g, w in zip(got, want):
        free = list(range(len(w["boxes"])))
        for i in range(len(g["boxes"])):
            hit = [j for j in free if w["classes"][j] == g["classes"][i]
                   and np.abs(w["boxes"][j] - g["boxes"][i]).max() <= box_tol
                   and abs(w["scores"][j] - g["scores"][i]) <= score_tol]
            if hit:
                free.remove(hit[0])
                matched += 1
                diff += int((g["masks"][i] != w["masks"][hit[0]]).sum())
                pixels += g["masks"][i].size
    total = sum(len(g["boxes"]) for g in got)
    return matched / max(total, 1), total, diff / max(pixels, 1)


def seg_fp32(card: str, model, meta):
    """edge_n_seg at 640, 2 images, TF32 off: level maps and prototypes card
    vs CPU; batched_nms + mask assembly of the CPU's outputs on the card
    (kernel) and the CPU (plain version): detections bit-exact, mask
    probabilities within SEG_PROB_TOL; then two 480x640 frames end to end:
    detections matched, binarized frame masks differing on at most
    SEG_PIXEL_SHARE of the pixels."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        triple = (model, model.state_dict(), meta)
        gpu = Predictor(triple, device="cuda", dtype=torch.float32)
        cpu = Predictor(triple, device="cpu", dtype=torch.float32)
        rng = np.random.RandomState(5)
        imgs = (rng.rand(2, IMG, IMG, 3) * 255).astype(np.uint8)
        kw = dict(conf=0.001, iou=0.45, max_det=300)
        with torch.inference_mode():
            og, pg = gpu.forward(torch.from_numpy(imgs).cuda())
            oc, pc = cpu.forward(torch.from_numpy(imgs))
            err = max(float((a.cpu() - b).abs().max()) for a, b in zip(og, oc))
            err_p = float((pg.cpu() - pc).abs().max())
            scale = max(float(b.abs().max()) for b in oc)
            scale_p = float(pc.abs().max())
            # the CPU's decoded outputs through NMS and the mask assembly on
            # the card (kernel) and on the CPU (plain version)
            d, scores, classes = _seg_decode(oc)
            kw_nms = dict(iou_th=kw["iou"], conf_th=kw["conf"], max_det=kw["max_det"],
                          pre_nms_topk=PRE_NMS_TOPK)
            want = batched_nms(d["box"], scores, classes, **kw_nms)
            got = batched_nms(d["box"].cuda(), scores.cuda(), classes.cuda(), **kw_nms)
            for name, a, b in zip(("boxes", "scores", "classes", "valid", "idx"), got, want):
                if not torch.equal(a.cpu(), b):
                    raise AssertionError(f"seg fp32 detections {name}: card != CPU")
            coef = torch.gather(d["coef"], 1, want[4][..., None].long().expand(
                -1, -1, d["coef"].shape[-1]))
            m_c = assemble_masks_batch(pc, coef, want[0], float(IMG))
            m_g = assemble_masks_batch(pc.cuda(), coef.cuda(), want[0].cuda(), float(IMG))
            prob_err = float((m_g.cpu() - m_c).abs().max())
        frames = [(rng.rand(480, 640, 3) * 255).astype(np.uint8) for _ in range(2)]
        dg = [gpu.infer_image_profiled(f, conf=0.001, max_det=100) for f in frames]
        dc = [cpu.infer_image_profiled(f, conf=0.001, max_det=100) for f in frames]
        frac, total, share = _paired_mask_share(dg, dc, 1e-2, 1e-5)
        fg = int(sum(int(d["masks"].sum()) for d in dc))
        log(f"seg fp32 card vs CPU (TF32 off, edge_n_seg @640, 2 images): level maps max abs "
            f"err {err:.3e} over |x| <= {scale:.2f}, prototypes {err_p:.3e} over |p| <= "
            f"{scale_p:.2f} (tolerance 1e-3); batched_nms of equal decoded inputs bit-exact "
            f"({int(want[3].sum())} valid), their mask probabilities max abs err {prob_err:.3e} "
            f"(tolerance {SEG_PROB_TOL:g}); 480x640 frames: {total} card detections, "
            f"{frac:.4f} matched (need >= 0.99), binarized masks differ on {share:.3e} of the "
            f"pixels (tolerance {SEG_PIXEL_SHARE:g}; {fg} foreground pixels) [{card}]")
        if not (err <= 1e-3 and err_p <= 1e-3 and prob_err <= SEG_PROB_TOL
                and total > 0 and fg > 0 and frac >= 0.99 and share <= SEG_PIXEL_SHARE):
            raise AssertionError("seg fp32 card vs CPU disagree")
        return {"fwd_max_abs_err": err, "protos_max_abs_err": err_p, "prob_max_abs_err": prob_err,
                "frame_dets": total, "matched": frac, "pixel_share": share}
    finally:
        torch.backends.cudnn.allow_tf32 = True


def seg_stages(pred, x, kw):
    """Per-stage device ms of one b128 seg graph (CUDA events)."""
    with torch.inference_mode():
        stages = {"forward": cuda_ms(lambda: pred.forward(x), 5)}
        outs, protos = pred.forward(x)
        stages["decode+scores"] = cuda_ms(lambda: _seg_decode(outs), 10)
        d, scores, classes = _seg_decode(outs)
        sel = lambda: select_candidates(d["box"], scores, classes, conf_th=kw["conf"],
                                        k=PRE_NMS_TOPK, class_aware=True)
        stages["topk+gather"] = cuda_ms(sel, 10)
        top, idx, boxes_k, cls_k, valid, shifted = sel()
        shifted = shifted.contiguous()
        stages["suppression"] = cuda_ms(
            lambda: cuda_nms.greedy_keep(shifted, valid, kw["iou"]), 20)
        keep = cuda_nms.greedy_keep(shifted, valid, kw["iou"])
        fin = lambda: finalize_detections(keep, top, idx, boxes_k, cls_k, max_det=kw["max_det"])
        stages["final top-k"] = cuda_ms(fin, 10)
        boxes, _, _, _, det_idx = fin()

        def assemble():
            coef = torch.gather(d["coef"], 1, det_idx[..., None].long().expand(
                -1, -1, d["coef"].shape[-1]))
            return assemble_masks_batch(protos.float(), coef, boxes, float(IMG))
        stages["mask assembly"] = cuda_ms(assemble, 5)
        stages["whole graph"] = cuda_ms(
            lambda: pred.postprocess(pred.forward(x), IMG, **kw), 5)
    return stages


def seg_serve(rel: str, cfg, model, dev, frame, card: str, tmp: str):
    """bf16 channels_last b128 device-resident serving with masks: 2 runs of
    SEG_BATCHES batches through infer_batched_stream and one
    YoloLite(ckpt, task="segment").predict frame, the kernel's launches
    counted; per-stage ms, peak GB."""
    meta = {"img_size": IMG, "names": ["c0", "c1", "c2"]}
    kw = dict(conf=0.001, iou=0.45, max_det=300)
    pred = Predictor((model, model.state_dict(), meta), device="cuda", dtype=torch.bfloat16)
    pred.warmup(**kw)
    list(pred.infer_batched_stream(dev[:1], prepared=True, **kw))
    ckpt = os.path.join(tmp, os.path.basename(rel).replace(".yaml", ".ckpt"))
    save_checkpoint(ckpt, *to_flax(model),
                    build_meta(cfg, {}, "AP", meta["names"], model.get_num_anchors_per_level()))
    api = YoloLite(ckpt, device="cuda", task="segment")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def stream():
        t0 = time.perf_counter()
        dets = sum(len(r["boxes"]) for out in pred.infer_batched_stream(
            (dev[i % len(dev)] for i in range(SEG_BATCHES)), prepared=True, depth=2, **kw)
            for r in out)
        return SEG_BATCHES * BATCH / (time.perf_counter() - t0), dets

    cuda_nms.LAUNCHES = 0
    runs = [stream() for _ in range(2)]
    r = api.predict(frame, **kw)[0]
    torch.cuda.synchronize()
    launches = cuda_nms.LAUNCHES
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    expected = 2 * SEG_BATCHES + 1
    if launches != expected:
        raise AssertionError(f"seg {rel}: nms_suppress launched {launches} times, "
                             f"expected {expected}")
    m = r["masks"]
    if not (m is not None and m.dtype == np.uint8 and m.shape == (len(r["boxes"]),) + frame.shape[:2]
            and len(r["boxes"]) > 0 and min(d for _, d in runs) > 0):
        raise AssertionError(f"seg {rel}: predict masks {None if m is None else m.shape}")
    stages = seg_stages(pred, dev[0], kw)
    ips = ", ".join(f"{v:.1f}" for v, _ in runs)
    log(f"seg serve {rel}: {count_params(model)} params; bf16 b{BATCH} img/s {ips} "
        f"(device-resident, masks assembled for all {kw['max_det']} slots and dropped); "
        f"nms_suppress launches {launches}; peak {peak_gb:.2f} GB; YoloLite.predict: "
        f"{len(r['boxes'])} masks {m.shape[1]}x{m.shape[2]} uint8 [{card}]")
    log(f"seg serve {rel} stages (ms per b{BATCH} batch): "
        + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()) + f" [{card}]")
    return {"img_s": [v for v, _ in runs], "launches": launches, "peak_gb": peak_gb,
            "stages_ms": stages, "predict_masks": list(m.shape)}


def seg_train_fp32_parity(cfg, card: str):
    """One fp32 seg forward+loss (TF32 off) on the card and on the CPU from
    the same weights and unaugmented batch: equal assignment, loss
    components (mask included) within TRAIN_FP32_LOSS_RTOL."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        params, stats = _seeded_flax_edge_n(cfg)
        ds = YoloDataset(cfg["dataset"]["train_images"], cfg["dataset"]["train_labels"],
                         img_size=IMG, is_train=True, augment=False, task="segment",
                         max_boxes=int(cfg["training"]["max_boxes"]), want_rles=False)
        batch = collate([ds.get(i) for i in range(8)])
        out = {}
        for dev in ("cuda", "cpu"):
            trainer = Trainer(build_model_from_config(cfg), cfg, total_updates=8, device=dev)
            state = trainer.state_from_weights(params, stats)
            total, m = trainer.forward_loss(state, trainer.put_batch(batch),
                                            return_assignment=True)
            out[dev] = {"total": float(total.detach()),
                        **{k: m[k].detach().cpu() for k in m}}
        g, c = out["cuda"], out["cpu"]
        pos = c["pos_mask"]
        equal = (torch.equal(g["pos_mask"], pos)
                 and torch.equal(g["matched_gt"][pos], c["matched_gt"][pos]))
        errs = {k: abs(float(g[k]) - float(c[k])) / max(abs(float(c[k])), 1e-12)
                for k in ("total", "box", "obj", "cls", "mask")}
        log(f"seg train fp32 card vs CPU (TF32 off, b8 @640): assignment "
            f"{'equal' if equal else 'DIFFERS'} ({int(pos.sum())} positives); loss rel err "
            f"{', '.join(f'{k} {v:.3e}' for k, v in errs.items())} (tolerance "
            f"{TRAIN_FP32_LOSS_RTOL:g}); mask loss {float(c['mask']):.4f} [{card}]")
        if not (equal and max(errs.values()) <= TRAIN_FP32_LOSS_RTOL):
            raise AssertionError("seg train fp32 card vs CPU disagree")
        return {"assignment_equal": equal, "positives": int(pos.sum()), "loss_rel_err": errs}
    finally:
        torch.backends.cudnn.allow_tf32 = True


def _count_seg_mixes():
    """Count calls of the dataset's seg mosaic and cutmix (thread-safe).
    Returns (counts, undo)."""
    import threading
    lock = threading.Lock()
    counts = {name: 0 for name in SEG_MIXES}
    saved = [(name, getattr(YoloDataset, name)) for name in SEG_MIXES]

    def wrap(fn, name):
        def counted(*a, **k):
            with lock:
                counts[name] += 1
            return fn(*a, **k)
        return counted

    for name, fn in saved:
        setattr(YoloDataset, name, wrap(fn, name))
    return counts, lambda: [setattr(YoloDataset, n, f) for n, f in saved]


def _mask_term_ms(trainer, state, batch):
    """Device ms of the loss's mask term alone (`mask_losses` forward and its
    backward to the coefficients and prototypes) on one train batch's model
    outputs and assignment, by CUDA events; and the positives it covers."""
    _, m = trainer.forward_loss(state, batch, return_assignment=True)
    with trainer._autocast():
        outs, protos = state.model(normalize_images(batch["image"].permute(0, 3, 1, 2)))
    flat, _ = flatten_levels([o.float().detach() for o in outs])
    coef = flat[..., 5 + trainer.model.num_classes:].contiguous().requires_grad_(True)
    protos = protos.float().detach().requires_grad_(True)
    gt_masks = gt_masks_from_batch(batch)
    pos, matched = m["pos_mask"].detach(), m["matched_gt"].detach()

    def term():
        loss = mask_losses(trainer.loss.cfg, coef, protos, batch["boxes"].float(), gt_masks,
                           pos, matched)
        torch.autograd.grad(loss.sum(), (coef, protos))
    pos_masks = int(torch.clamp(pos.sum(-1), max=trainer.loss.cfg.max_pos_masks).sum())
    return cuda_ms(term, 10), pos_masks


def seg_train(card: str, tmp: str):
    """edge_n_seg trained at 640 b8 bf16 for 2 epochs through YoloLite.train
    on a synthetic polygon set, standard_train.yaml's augmentation (seg
    mosaic and cutmix counted); nms_suppress launches counted over the run;
    an fp32 forward+loss card vs CPU; the step timed and split."""
    data = make_seg_set(os.path.join(tmp, "seg"), TRAIN_N, VAL_N)
    runs = os.path.join(tmp, "seg_runs")
    counts, undo = _count_seg_mixes()
    try:
        api = YoloLite("edge_n_seg", device="cuda", task="segment")
        torch.cuda.synchronize()
        cuda_nms.LAUNCHES = 0
        t0 = time.perf_counter()
        res = api.train(data=data, workers=8, run_dir=runs, **SEG_TRAIN_OVERRIDES)
        torch.cuda.synchronize()
        launches = cuda_nms.LAUNCHES
        train_s = time.perf_counter() - t0
    finally:
        undo()
    hist = res["history"]
    val_batches = -(-VAL_N // SEG_TRAIN_OVERRIDES["batch_size"])
    expected = (SEG_TRAIN_OVERRIDES["epochs"] + 1) * val_batches
    segm = res.get("coco_segm")
    log(f"seg train (edge_n_seg, augment on): {SEG_TRAIN_OVERRIDES['epochs']} epochs in "
        f"{train_s:.1f} s; epoch train loss {', '.join(f'{v:.4f}' for v in hist['train_loss'])}; "
        f"val loss {', '.join(f'{v:.4f}' for v in hist['val_loss'])}; seg mosaic "
        f"{counts['mosaic_segment']} and cutmix {counts['cutmix_segment']} calls; final bbox "
        f"AP50 {res['coco']['AP50']:.4f}, segm AP50 {segm['AP50'] if segm else float('nan'):.4f}; "
        f"nms_suppress launched {launches} times (expected {expected}) [{card}]")
    if launches != expected:
        raise AssertionError("seg train: the validation path did not go through the kernel")
    if not all(np.isfinite(hist["step_loss"] + hist["val_loss"])):
        raise AssertionError(f"seg train: non-finite loss {hist}")
    if not hist["val_loss"][1] < hist["val_loss"][0]:
        raise AssertionError("seg train: epoch 2's val loss is not below epoch 1's")
    if segm is None or min(counts.values()) == 0:
        raise AssertionError(f"seg train: coco_segm {segm}, mixes {counts}")
    _check_run_dir(res["log_dir"])

    cfg = load_configs(os.path.join(ROOT, "configs", "models", "edge_n_seg.yaml"),
                       os.path.join(ROOT, "configs", "train", "standard_train.yaml"),
                       data, make_run_dir=False)
    cfg["training"].update(augment=False, amp=False, img_size=IMG, batch_size=8)
    fp32 = seg_train_fp32_parity(cfg, card)
    cfg["training"].update(augment=True, amp=True)
    prof, (trainer, state, dev, lr) = _step_profile(cfg, data, card,
                                                    f"seg train step b8 bf16 @{IMG}, augment on")
    split, synced_ms, peak_gb, metrics = _step_split(trainer, state, dev, lr, 10)
    mask_ms, positives = _mask_term_ms(trainer, state, dev[0])
    log(f"seg train step split (events, synced each step: {synced_ms:.3f} ms host clock): "
        f"forward+loss {split[0]:.3f}, backward {split[1]:.3f}, optimizer+EMA {split[2]:.3f} ms; "
        f"peak {peak_gb:.2f} GB; last step's mask loss {metrics['mask']:.4f}; the mask term "
        f"(mask_losses forward and backward, {positives} positives) {mask_ms:.3f} ms of device "
        f"time, {100 * mask_ms * 3 / max(prof['busy_ms'], 1e-9):.1f}% of the step's device "
        f"busy time "
        f"[{card}]")
    if not np.isfinite(metrics["mask"]):
        raise AssertionError("seg train: non-finite mask loss")
    return {"launches": launches, "train_s": train_s, "history": hist, "coco": res["coco"],
            "coco_segm": segm, "mixes": counts, "fp32": fp32,
            "step": dict(prof, split_ms=split.tolist(), synced_step_ms=synced_ms,
                         peak_gb=peak_gb, mask_loss=metrics["mask"],
                         mask_term_ms=mask_ms)}


def phase_seg(card: str, tmp: str):
    """Instance segmentation on the card: fp32 card vs CPU, b128 serving of
    both seg configs, and 2 epochs of edge_n_seg training."""
    rng = np.random.RandomState(6)
    dev = [torch.from_numpy((rng.rand(BATCH, IMG, IMG, 3) * 255).astype(np.uint8)).cuda()
           for _ in range(2)]
    frame = (rng.rand(480, 640, 3) * 255).astype(np.uint8)
    out = {"serve": {}}
    for rel in SEG_CONFIGS:
        cfg = _seg_config(rel)
        model = _seg_model(rel, cfg, dev[0][:2].clone())
        if rel == SEG_CONFIGS[0]:
            out["fp32"] = seg_fp32(card, model, {"img_size": IMG, "names": ["c0", "c1", "c2"]})
        out["serve"][rel] = seg_serve(rel, cfg, model, dev, frame, card, tmp)
        del model
        torch.cuda.empty_cache()
    out["train"] = seg_train(card, tmp)
    return out


# --------------------------------------------------------------------------- #
def _cpu_name() -> str:
    """The host CPU's model name (the codecs run there), from `lscpu` or
    /proc/cpuinfo, with the cores this process may use."""
    cores = len(os.sched_getaffinity(0))
    sources = []
    try:
        sources.append(subprocess.run(["lscpu"], capture_output=True, text=True).stdout)
    except OSError:
        pass
    try:
        with open("/proc/cpuinfo") as f:
            sources.append(f.read())
    except OSError:
        pass
    for text in sources:
        for line in text.splitlines():
            key, _, value = line.partition(":")
            if key.strip().lower() in ("model name", "cpu model", "hardware") and value.strip():
                return f"{value.strip()}, {cores} cores"
    import platform
    return f"{platform.machine()} CPU (model name not exposed), {cores} cores"


def _decode_ms(path: str, threads: int, n: int = 48) -> float:
    """Host ms per image of imread_bgr(path), n reads over `threads` threads."""
    host_codecs.imread_bgr(path)

    def work(k):
        for _ in range(k, n, threads):
            host_codecs.imread_bgr(path)
    pool = [threading.Thread(target=work, args=(k,)) for k in range(threads)]
    t0 = time.perf_counter()
    for t in pool:
        t.start()
    for t in pool:
        t.join()
    return (time.perf_counter() - t0) * 1e3 / n


def phase_codecs(card: str, png_data: str, tmp: str):
    """The host image codecs on the card's machine: (a) the libraries built
    there by its own compiler (phase_build); (b) every committed fixture
    decoded to the SHA-256 that cv2.imread gave when it was written; (c) host
    decode ms per 640x480 image on 1 and 8 threads (JPEG, PNG, a TIFF as
    cv2.imwrite writes it, lossy and lossless WebP) and the loader's ms per
    b8 batch on a JPEG copy of the synthetic set against the PNG set; (d)
    edge_n trained one epoch at 640 b8 by the recipe's defaults on the JPEG
    copy and on a TIFF copy, validation through nms_suppress; (e)
    YoloLite.predict on a JPEG path, a JPEG folder, a TIFF path and a WebP
    path, boxes equal to the same frames passed as arrays; (f)
    pretrain_backbone one epoch on an imagefolder of WebPs and CMYK JPEGs."""
    cpu = _cpu_name()
    out = {"cpu": cpu, "library": [str(kbuild.library_path(n)) for n in ("imgcodec", "webpcodec")]}
    cxx = kbuild.cxx_path()
    version = subprocess.run([cxx, "--version"], capture_output=True, text=True).stdout
    log(f"codecs: {', '.join(out['library'])} built by {cxx} ({version.splitlines()[0]}) "
        f"on {cpu}")
    # (b) fixtures against cv2's manifest
    with open(os.path.join(CODEC_FIXTURES, "manifest.json")) as f:
        manifest = json.load(f)
    for name, entry in sorted(manifest.items()):
        img = host_codecs.imread_bgr(os.path.join(CODEC_FIXTURES, name))
        digest = hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()
        if list(img.shape) != entry["shape"] or digest != entry["sha256"]:
            raise AssertionError(f"codecs: {name} decodes to {img.shape} {digest[:16]}, "
                                 f"cv2.imread gave {entry['shape']} {entry['sha256'][:16]}")
    out["fixtures"] = len(manifest)
    log(f"codecs: {len(manifest)} fixtures decode to cv2.imread's SHA-256 "
        f"({', '.join(sorted(manifest))})")
    # (c) host decode and the loader
    frame = np.asarray(host_codecs.imread_bgr(
        os.path.join(CODEC_FIXTURES, "progressive_640x480.jpg"))[..., ::-1])
    files = {"baseline JPEG 4:2:0 q90": os.path.join(tmp, "frame.jpg"),
             "progressive JPEG q75": os.path.join(CODEC_FIXTURES, "progressive_640x480.jpg"),
             "PNG": os.path.join(tmp, "frame.png"),
             "TIFF LZW + predictor 2": os.path.join(tmp, "frame.tif"),
             "lossy WebP q75": os.path.join(CODEC_FIXTURES, "webp_lossy_640x480.webp"),
             "lossless WebP": os.path.join(CODEC_FIXTURES, "webp_lossless_640x480.webp")}
    write_jpeg(files["baseline JPEG 4:2:0 q90"], frame, quality=90)
    write_png(files["PNG"], frame)
    write_tiff(files["TIFF LZW + predictor 2"], frame)       # cv2.imwrite's default layout
    if not np.array_equal(host_codecs.imread_bgr(files["TIFF LZW + predictor 2"]),
                          np.ascontiguousarray(frame[..., ::-1])):
        raise AssertionError("codecs: the port's TIFF does not read back to its frame")
    out["decode_ms"] = {}
    for kind, path in files.items():
        ms = {t: _decode_ms(path, t) for t in (1, 8)}
        out["decode_ms"][kind] = ms
        log(f"codecs: host decode 640x480 {kind} ({os.path.getsize(path)} bytes): "
            f"{ms[1]:.3f} ms/image on 1 thread, {ms[8]:.3f} on 8 [{cpu}; {card}]")
    t0 = time.perf_counter()
    jpg_data = make_synth_set(os.path.join(tmp, "synth_jpg"), TRAIN_N, VAL_N, fmt="jpg")
    log(f"codecs: wrote the synthetic set's {TRAIN_N} + {VAL_N} images as baseline JPEGs "
        f"in {time.perf_counter() - t0:.2f} s")
    out["loader_ms"] = {"png": [], "jpeg": []}
    for kind in ("png", "jpeg", "jpeg", "png"):
        root = os.path.dirname(png_data if kind == "png" else jpg_data)
        ds = YoloDataset(os.path.join(root, "train", "images"),
                         os.path.join(root, "train", "labels"), img_size=IMG, is_train=True,
                         augment=False)
        out["loader_ms"][kind].append(_loader_epoch_ms(ds))
    log(f"codecs: loader ms per b8 batch (8 threads, augmentation off, {IMG} letterbox): PNG "
        f"{', '.join(f'{v:.1f}' for v in out['loader_ms']['png'])}; JPEG "
        f"{', '.join(f'{v:.1f}' for v in out['loader_ms']['jpeg'])} [{cpu}; {card}]")
    # (d) one epoch on the JPEG set
    overrides = dict(TRAIN_OVERRIDES, epochs=1)
    api = YoloLite("edge_n", device="cuda")
    torch.cuda.synchronize()
    cuda_nms.LAUNCHES = 0
    t0 = time.perf_counter()
    res = api.train(data=jpg_data, workers=8, run_dir=os.path.join(tmp, "runs_jpg"),
                    **overrides)
    torch.cuda.synchronize()
    launches = cuda_nms.LAUNCHES
    hist = res["history"]
    val_batches = -(-VAL_N // overrides["batch_size"])
    expected = 2 * val_batches
    out["train"] = {"launches": launches, "train_s": time.perf_counter() - t0,
                    "step_loss": hist["step_loss"], "val_loss": hist["val_loss"],
                    "AP50": res["coco"]["AP50"]}
    log(f"codecs: edge_n 1 epoch @640 b8 on the JPEG set in {out['train']['train_s']:.1f} s, "
        f"step losses {', '.join(f'{v:.3f}' for v in hist['step_loss'])}, val loss "
        f"{hist['val_loss'][0]:.4f}, AP50 {res['coco']['AP50']:.4f}, nms_suppress launched "
        f"{launches} times (expected {expected}: {val_batches} val batch + {val_batches} in "
        f"evaluate_model) [{card}]")
    if launches != expected:
        raise AssertionError("codecs: JPEG validation did not go through the kernel")
    if not np.isfinite(hist["step_loss"] + hist["val_loss"]).all():
        raise AssertionError(f"codecs: non-finite loss {hist}")
    out["train_tiff"] = _codecs_tiff_epoch(card, tmp, overrides)
    # (e) predict on JPEG sources against the same frames as arrays
    folder = os.path.join(os.path.dirname(jpg_data), "valid", "images")
    paths = sorted(glob.glob(os.path.join(folder, "*.jpg")))
    arrays = [host_codecs.imread_bgr(p) for p in paths]
    cuda_nms.LAUNCHES = 0
    one = api.predict(paths[0], conf=0.001)[0]
    many = api.predict(folder, conf=0.001)
    out["predict_launches"] = cuda_nms.LAUNCHES
    if out["predict_launches"] < 2:
        raise AssertionError("codecs: predict on JPEG sources did not launch nms_suppress")
    want_one = api.predict(arrays[0], conf=0.001)[0]
    want_many = api.predict(arrays, conf=0.001)
    if [r["source"] for r in many] != paths:
        raise AssertionError("codecs: predict(folder) did not read the folder's JPEGs in order")
    for got, want in zip([one] + many, [want_one] + want_many):
        if not (np.array_equal(got["boxes"], want["boxes"])
                and np.array_equal(got["classes"], want["classes"])):
            raise AssertionError("codecs: predict on a JPEG path differs from its array")
    out["predict_boxes"] = [len(r["boxes"]) for r in many]
    log(f"codecs: YoloLite.predict on a JPEG path ({len(one['boxes'])} boxes) and a folder of "
        f"{len(paths)} ({out['predict_boxes']} boxes) equal to the frames as arrays; "
        f"nms_suppress launched {out['predict_launches']} times [{card}]")
    tif_path = sorted(glob.glob(os.path.join(out["train_tiff"]["root"], "valid", "images",
                                             "*.tif")))[0]
    out["predict_tiff_webp"] = {}
    for kind, path in (("TIFF", tif_path),
                       ("WebP", os.path.join(CODEC_FIXTURES, "webp_lossy_640x480.webp"))):
        cuda_nms.LAUNCHES = 0
        got = api.predict(path, conf=0.001)[0]
        launches = cuda_nms.LAUNCHES
        want = api.predict(host_codecs.imread_bgr(path), conf=0.001)[0]
        if not (np.array_equal(got["boxes"], want["boxes"])
                and np.array_equal(got["classes"], want["classes"]) and launches == 1):
            raise AssertionError(f"codecs: predict on a {kind} path differs from its array "
                                 f"(or launched nms_suppress {launches} times)")
        out["predict_tiff_webp"][kind] = len(got["boxes"])
    log(f"codecs: YoloLite.predict on a TIFF path and a WebP path "
        f"({out['predict_tiff_webp']} boxes) equal to the frames as arrays, one nms_suppress "
        f"launch each [{card}]")
    out["pretrain"] = _codecs_pretrain(card, tmp)
    return out


def _codecs_tiff_epoch(card: str, tmp: str, overrides: dict) -> dict:
    """edge_n one epoch on a TIFF copy of the synthetic set (the port's TIFF
    writer, cv2.imwrite's layout): validation's nms_suppress launches as
    the JPEG run's."""
    t0 = time.perf_counter()
    data = make_synth_set(os.path.join(tmp, "synth_tif"), TRAIN_N, VAL_N, fmt="tif")
    log(f"codecs: wrote the synthetic set's {TRAIN_N} + {VAL_N} images as TIFFs "
        f"(LZW + predictor 2) in {time.perf_counter() - t0:.2f} s")
    api = YoloLite("edge_n", device="cuda")
    torch.cuda.synchronize()
    cuda_nms.LAUNCHES = 0
    t0 = time.perf_counter()
    res = api.train(data=data, workers=8, run_dir=os.path.join(tmp, "runs_tif"), **overrides)
    torch.cuda.synchronize()
    hist = res["history"]
    val_batches = -(-VAL_N // overrides["batch_size"])
    expected = 2 * val_batches
    out = {"root": os.path.dirname(data), "launches": cuda_nms.LAUNCHES,
           "train_s": time.perf_counter() - t0, "step_loss": hist["step_loss"],
           "val_loss": hist["val_loss"], "AP50": res["coco"]["AP50"]}
    log(f"codecs: edge_n 1 epoch @640 b8 on the TIFF set in {out['train_s']:.1f} s, step losses "
        f"{', '.join(f'{v:.3f}' for v in hist['step_loss'])}, val loss {hist['val_loss'][0]:.4f}, "
        f"AP50 {res['coco']['AP50']:.4f}, nms_suppress launched {out['launches']} times "
        f"(expected {expected}: {val_batches} val batch + {val_batches} in evaluate_model) "
        f"[{card}]")
    if out["launches"] != expected:
        raise AssertionError("codecs: TIFF validation did not go through the kernel")
    if not np.isfinite(hist["step_loss"] + hist["val_loss"]).all():
        raise AssertionError(f"codecs: non-finite loss on the TIFF set {hist}")
    return out


CODECS_PRETRAIN = {"webp": ["webp_lossy_640x480.webp", "webp_lossless_640x480.webp",
                            "webp_lossy_q90.webp", "webp_lossless_alpha.webp",
                            "webp_exif6.webp", "webp_simple_filter.webp"],
                   "cmyk": ["cmyk.jpg", "cmyk_progressive_420.jpg"] * 3}


def _codecs_pretrain(card: str, tmp: str) -> dict:
    """pretrain_backbone one epoch (b4 @64) on an imagefolder whose classes
    are the WebP and the CMYK JPEG fixtures (train 6 a class, val 2): every
    image read (none a zero image), the loss finite."""
    root = os.path.join(tmp, "webp_cmyk_folder")
    for split in ("train", "val"):
        for cls, names in CODECS_PRETRAIN.items():
            os.makedirs(os.path.join(root, split, cls), exist_ok=True)
            for i, name in enumerate(names if split == "train" else names[:2]):
                shutil.copy(os.path.join(CODEC_FIXTURES, name),
                            os.path.join(root, split, cls, f"{i}_{name}"))
    samples, _ = cli_pretrain.list_imagefolder(os.path.join(root, "train"))
    imgs, _ = cli_pretrain.make_batch(samples, list(range(len(samples))), 64,
                                      np.random.RandomState(0), train=False)
    if not all(im.any() for im in imgs):
        raise AssertionError("codecs: a WebP or CMYK JPEG was read as a zero image")
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli_pretrain.pretrain(root, backbone=PRETRAIN["backbone"],
                              out=os.path.join(tmp, "webp_cmyk.ckpt"), epochs=1, batch_size=4,
                              img_size=64, log_every=1, device="cuda")
    torch.cuda.synchronize()
    losses = [float(ln.split(" loss ")[1].split()[0]) for ln in buf.getvalue().splitlines()
              if " loss " in ln]
    out = {"images": len(samples), "losses": losses, "seconds": time.perf_counter() - t0}
    log(f"codecs: pretrain_backbone 1 epoch b4 @64 on {len(samples)} WebP and CMYK JPEG images "
        f"in {out['seconds']:.1f} s, losses {', '.join(f'{v:.4f}' for v in losses)} [{card}]")
    if not losses or not np.all(np.isfinite(losses)):
        raise AssertionError(f"codecs: pretrain on WebP and CMYK JPEG: losses {losses}")
    return out


def make_clip(n: int = STREAM_FRAMES, h: int = 480, w: int = 640, seed: int = 0):
    """BGR frames of a synthetic clip: five coloured rectangles moving at
    constant velocity (bouncing off the borders) over dark noise."""
    rng = np.random.RandomState(seed)
    size = rng.randint(40, 160, (5, 2))
    pos = rng.rand(5, 2) * ([w, h] - size)
    vel = rng.randn(5, 2) * 6
    colour = rng.randint(80, 256, (5, 3)).astype(np.uint8)
    frames = []
    for t in range(n):
        f = (rng.rand(h, w, 3) * 40).astype(np.uint8)
        for (bw, bh), p, v, c in zip(size, pos, vel, colour):
            span = np.array([w - bw, h - bh], float)
            x, y = np.abs((p + v * t + span) % (2 * span) - span).astype(int)
            f[y:y + bh, x:x + bw] = c
        frames.append(f)
    return frames


def _track(dets):
    """KalmanSortTracker over per-frame (boxes, scores, classes), each
    frame's TRACK_TOP best; returns the reported tracks and host ms a frame."""
    tracker, tracks, secs = KalmanSortTracker(), [], 0.0
    for b, s, c in dets:
        t0 = time.perf_counter()
        out = tracker.update(b[:TRACK_TOP], s[:TRACK_TOP], c[:TRACK_TOP])
        secs += time.perf_counter() - t0
        tracks.append([(o["track_id"], o["bbox"].tolist(), o["cls"]) for o in out])
    return tracks, secs * 1e3 / max(len(dets), 1)


def _op_host_us(iters: int = 200):
    """Host microseconds a call: greedy_keep through the registered op
    against the same launch called directly (B=1, k=512), to show what the
    dispatcher adds per call."""
    boxes, valid = _dense_boxes(np.random.RandomState(9), 1, PRE_NMS_TOPK)
    out = {}
    for name, fn in (("op", lambda: cuda_nms.greedy_keep(boxes, valid, 0.45)),
                     ("direct", lambda: cuda_nms._nms_suppress_cuda(boxes, valid, 0.45))):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        out[name] = (time.perf_counter() - t0) * 1e6 / iters
        torch.cuda.synchronize()
    return out


def phase_stream(card: str):
    """Streaming video on the card: edge_n @640 bf16 (seeded heads, bundled
    backbone) over a 120-frame synthetic 480x640 clip. infer_stream at each
    depth yields exactly infer_image's boxes, scores and classes per frame,
    with one nms_suppress launch a frame; the tracker fed from the stream
    gives infer_image's tracks. Prints frames/s a depth, serial infer_image
    ms, tracker ms, the share of host time in `_upload` (a pinned buffer a
    frame) and the op's host cost a call."""
    model = _edge_n_model()
    meta = {"img_size": IMG, "names": ["c0", "c1", "c2"]}
    pred = Predictor((model, model.state_dict(), meta), device="cuda", dtype=torch.bfloat16)
    frames = make_clip()
    kw = dict(conf=0.001, iou=0.45, max_det=300)
    upload_s = []
    upload = pred._upload

    def timed_upload(batch):
        t0 = time.perf_counter()
        out = upload(batch)
        upload_s.append(time.perf_counter() - t0)
        return out
    pred._upload = timed_upload
    pred.warmup(**kw)
    list(pred.infer_stream(frames[:8], depth=2, **kw))
    torch.cuda.synchronize()
    out = {"frames": len(frames)}
    # serial infer_image: the reference detections and the frame latency
    cuda_nms.LAUNCHES = 0
    upload_s.clear()
    ref, single_ms = [], []
    t0 = time.perf_counter()
    for f in frames:
        t1 = time.perf_counter()
        ref.append(pred.infer_image(f, **kw))
        single_ms.append((time.perf_counter() - t1) * 1e3)
    wall = time.perf_counter() - t0
    if cuda_nms.LAUNCHES != len(frames):
        raise AssertionError(f"stream: infer_image launched nms_suppress "
                             f"{cuda_nms.LAUNCHES} times for {len(frames)} frames")
    out["infer_image"] = {"fps": len(frames) / wall, "median_ms": float(np.median(single_ms)),
                          "p90_ms": float(np.percentile(single_ms, 90)),
                          "upload_share": sum(upload_s) / wall,
                          "upload_ms": sum(upload_s) * 1e3 / len(frames)}
    if sum(len(b) for b, _, _ in ref) == 0:
        raise AssertionError("stream: infer_image found no detections")
    log(f"stream: serial infer_image over {len(frames)} 480x640 frames: "
        f"{out['infer_image']['fps']:.1f} frames/s, median {out['infer_image']['median_ms']:.2f}"
        f" ms, p90 {out['infer_image']['p90_ms']:.2f} ms; _upload "
        f"{out['infer_image']['upload_ms']:.3f} ms a frame, "
        f"{100 * out['infer_image']['upload_share']:.1f}% of the host time [{card}]")
    out["depths"], launches = {}, 0
    for depth in STREAM_DEPTHS:
        cuda_nms.LAUNCHES = 0
        upload_s.clear()
        t0 = time.perf_counter()
        res = list(pred.infer_stream(iter(frames), depth=depth, **kw))
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        if cuda_nms.LAUNCHES != len(frames) or len(res) != len(frames):
            raise AssertionError(f"stream depth {depth}: {cuda_nms.LAUNCHES} launches, "
                                 f"{len(res)} results for {len(frames)} frames")
        launches += cuda_nms.LAUNCHES
        for i, (r, (b, s, c)) in enumerate(zip(res, ref)):
            if not (np.array_equal(r["boxes"], b) and np.array_equal(r["scores"], s)
                    and np.array_equal(r["classes"], c)):
                raise AssertionError(f"stream depth {depth}: frame {i} differs from "
                                     f"infer_image")
        row = {"fps": len(frames) / wall, "upload_share": sum(upload_s) / wall,
               "preprocess_ms": float(np.mean([r["speed"]["preprocess_ms"] for r in res])),
               "sync_ms": float(np.mean([r["speed"]["sync_ms"] for r in res]))}
        out["depths"][depth] = row
        log(f"stream: infer_stream depth {depth}: {row['fps']:.1f} frames/s, every frame equal "
            f"to infer_image, {len(frames)} nms_suppress launches; preprocess "
            f"{row['preprocess_ms']:.2f} ms, sync {row['sync_ms']:.2f} ms a frame; _upload "
            f"{100 * row['upload_share']:.1f}% of the host time [{card}]")
        if depth == 2:
            streamed = [(r["boxes"], r["scores"], r["classes"]) for r in res]
    out["launches"] = launches
    got, track_ms = _track(streamed)
    want, _ = _track(ref)
    if got != want:
        raise AssertionError("stream: tracks over infer_stream differ from infer_image's")
    ids = {t[0] for frame in got for t in frame}
    out["tracker"] = {"ms_per_frame": track_ms, "tracks": len(ids),
                      "reported": sum(len(f) for f in got)}
    log(f"stream: KalmanSortTracker over the stream (each frame's {TRACK_TOP} best): the same "
        f"{len(ids)} track ids, boxes and classes as over infer_image; host "
        f"{track_ms:.3f} ms a frame")
    out["op_host_us"] = _op_host_us()
    log(f"stream: host us a greedy_keep call at B=1, k={PRE_NMS_TOPK}: registered op "
        f"{out['op_host_us']['op']:.1f}, direct launch {out['op_host_us']['direct']:.1f} "
        f"[{card}]")
    return out


def _scale_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Max abs difference over the larger of 1 and the outputs' max abs."""
    want = want.float()
    return float((got.float() - want).abs().max()) / max(1.0, float(want.abs().max()))


def _iou_matched(got, want, iou_min: float):
    """Share of valid detections of `want` (boxes, scores, classes, valid) that
    `got` has with the same class at IoU >= iou_min, per image."""
    from yololite_tpu_torch.ops.boxes import box_iou_matrix
    hits = total = 0
    for i in range(want[0].shape[0]):
        vw, vg = want[3][i], got[3][i]
        bw, cw, bg, cg = want[0][i][vw], want[2][i][vw], got[0][i][vg], got[2][i][vg]
        total += len(bw)
        if len(bw) and len(bg):
            iou = box_iou_matrix(bw.float(), bg.float()) * (cw[:, None] == cg[None, :])
            hits += int((iou.amax(1) >= iou_min).sum())
    return hits / max(total, 1), total


def _export_model(rel: str, calib: torch.Tensor):
    cfg = _seg_config(rel)
    if "seg" in rel:
        return cfg, _seg_model(rel, cfg, calib)
    return cfg, _edge_n_model()


def _export_one(card, rel, fmt, dtype, ckpt, out_dir, x, want, times):
    """Export `fmt` at b128 in `dtype`, load it, call it on `x` once with
    the launches counted, and compare with the eager graph's `want`."""
    name = str(dtype).replace("torch.", "")
    t0 = time.perf_counter()
    path = deploy_export.export_model(ckpt, out_dir=os.path.join(out_dir, name), fmt=fmt,
                                      batch=BATCH, img_size=IMG, dtype=dtype, device="cuda")
    call, meta = deploy_export.load_exported(path)
    times[f"{fmt}_{name}"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    cuda_nms.LAUNCHES = 0
    torch.cuda.reset_peak_memory_stats()
    got = call(x)
    torch.cuda.synchronize()
    row = {"launches": cuda_nms.LAUNCHES, "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "export_s": times[f"{fmt}_{name}"], "mb": os.path.getsize(path) / 1e6}
    if row["launches"] != (fmt == "nms"):
        raise AssertionError(f"export {rel} {fmt} {name}: {row['launches']} launches")
    got = list(got.values()) if isinstance(got, dict) else list(got)
    want = list(want.values()) if isinstance(want, dict) else list(want)
    if len(got) != len(want) or meta["outputs"] != deploy_export.output_names(
            "seg" in rel, fmt, 3):
        raise AssertionError(f"export {rel} {fmt}: outputs {meta['outputs']}")
    if fmt != "nms" and dtype == torch.float32:
        row["err"] = max(_scale_err(g, w) for g, w in zip(got, want))
        ok = row["err"] <= EXPORT_FP32_RTOL
    elif fmt == "nms" and dtype == torch.float32:
        same = torch.equal(got[3], want[3]) and torch.equal(got[2], want[2])
        row["err"] = max(_scale_err(got[0], want[0]), _scale_err(got[1], want[1]))
        ok = same and row["err"] <= EXPORT_FP32_RTOL
    elif fmt == "nms":
        row["matched"], row["dets"] = _iou_matched(got, want, 0.99)
        ok = row["matched"] >= EXPORT_BF16_MATCH and row["dets"] > 0
    else:
        row["err"] = max(_scale_err(g, w) for g, w in zip(got, want))
        ok = True                       # bf16 raw/decoded: read, not held
    if fmt == "nms" and len(got) == 5:
        row["mask_share"] = float(((got[4] > 0.5) != (want[4] > 0.5)).float().mean())
        ok = ok and row["mask_share"] <= SEG_PIXEL_SHARE
    log(f"export {os.path.basename(rel)} {fmt} {name}: {row} [{card}]")
    if not ok:
        raise AssertionError(f"export {rel} {fmt} {name} disagrees with the eager graph")
    return call, row


def _eager(pred, fmt, x):
    """The Predictor's eager graph in the outputs of export format `fmt`."""
    with torch.inference_mode():
        return deploy_export.graph_outputs(pred, pred.forward(x), fmt, IMG, 0.001, 0.65, 300)


def phase_export(card: str, tmp: str):
    """Export on the card: edge_n and edge_n_seg as "raw", "decoded" and "nms"
    `.pt2` at b128 @640, fp32 then bf16, from a checkpoint saved from the
    seeded model, each loaded back and held against the Predictor's eager
    graph on one fixed uint8 batch, one nms_suppress launch an "nms" call;
    the bf16 "nms" artifact timed against the Predictor's graph; seg "nms"
    peak GB; edge_n "raw"/"decoded" ONNX (batch 1 and a dynamic-batch file)
    run on the host against the card's fp32 "decoded"; `.tflite` files of
    both models run on the host against the card's fp32 graph
    (export_tflite_host); YoloLite.export once."""
    rng = np.random.RandomState(8)
    x = torch.from_numpy((rng.rand(BATCH, IMG, IMG, 3) * 255).astype(np.uint8)).cuda()
    out = {"models": {}, "launches": 0}
    out_dir = os.path.join(tmp, "export")
    for rel in EXPORT_CONFIGS:
        cfg, model = _export_model(rel, x[:2].clone())
        names = ["c0", "c1", "c2"]
        ckpt = os.path.join(tmp, os.path.basename(rel).replace(".yaml", ".ckpt"))
        save_checkpoint(ckpt, *to_flax(model),
                        build_meta(cfg, {}, "AP", names, model.get_num_anchors_per_level()))
        rows, times, calls = {}, {}, {}
        for dtype in (torch.float32, torch.bfloat16):
            torch.backends.cudnn.allow_tf32 = dtype != torch.float32
            torch.backends.cuda.matmul.allow_tf32 = dtype != torch.float32
            try:
                pred = Predictor(ckpt, device="cuda", dtype=dtype)
                for fmt in deploy_export.FORMATS:
                    want = _eager(pred, fmt, x)
                    call, row = _export_one(card, rel, fmt, dtype, ckpt, out_dir, x, want,
                                            times)
                    out["launches"] += row["launches"]
                    rows[f"{fmt}_{str(dtype)[6:]}"] = row
                    calls[f"{fmt}_{str(dtype)[6:]}"] = call
                    del want
                    torch.cuda.empty_cache()
                if dtype == torch.float32:
                    rows["tflite"] = export_tflite_host(card, rel, ckpt, pred, x, out_dir)
            finally:
                torch.backends.cudnn.allow_tf32 = True
                torch.backends.cuda.matmul.allow_tf32 = False
        # the bf16 "nms" artifact against the Predictor's whole graph
        call = calls["nms_bfloat16"]
        with torch.inference_mode():
            graph_ms = cuda_ms(lambda: pred.postprocess(pred.forward(x), IMG, 0.001, 0.65, 300), 5)
            torch.cuda.reset_peak_memory_stats()
            pred.postprocess(pred.forward(x), IMG, 0.001, 0.65, 300)
            torch.cuda.synchronize()
            graph_peak = torch.cuda.max_memory_allocated() / 1e9
        art_ms = cuda_ms(lambda: call(x), 5)
        rows["nms_bf16_ms"], rows["graph_bf16_ms"] = art_ms, graph_ms
        rows["graph_bf16_peak_gb"] = graph_peak
        log(f"export {os.path.basename(rel)}: bf16 nms artifact {art_ms:.3f} ms per b{BATCH} "
            f"call, the Predictor's graph {graph_ms:.3f} ms; peak {rows['nms_bfloat16']['peak_gb']:.2f}"
            f" GB (fp32 {rows['nms_float32']['peak_gb']:.2f}) against the graph's "
            f"{graph_peak:.2f}; export + save + load {sum(times.values()):.1f} s for 6 "
            f"artifacts [{card}]")
        out["models"][rel] = rows
        del model, pred, calls, call
        torch.cuda.empty_cache()
    out["onnx"] = export_onnx_host(card, os.path.join(tmp, "edge_n.ckpt"), out_dir, x)
    t0 = time.perf_counter()
    api_path = YoloLite(os.path.join(tmp, "edge_n.ckpt")).export()
    api_call, api_meta = deploy_export.load_exported(api_path)
    api_out = api_call(x[:1])
    if not (api_path.endswith("_decoded.pt2") and api_meta["dtype"] == "bfloat16"
            and torch.isfinite(api_out["boxes_xyxy"]).all()):
        raise AssertionError(f"YoloLite.export: {api_path} {api_meta}")
    out["api_export_s"] = time.perf_counter() - t0
    log(f"export: YoloLite.export() -> {os.path.basename(api_path)} (decoded, b1, bf16, "
        f"{out['api_export_s']:.1f} s), finite outputs on the card")
    return out


def _tflite_conf(scores: torch.Tensor, lo: int = 64, hi: int = 384) -> float:
    """A conf threshold in the widest gap between the scores of the images
    (any image's) from the lowest lo-th to the highest hi-th of each image:
    fewer than PRE_NMS_TOPK candidates pass, and no score within fp32
    rounding of the threshold can cross it."""
    s = scores.float().sort(dim=1, descending=True).values.cpu()
    lo, hi = min(lo, s.shape[1] // 16), min(hi, s.shape[1] // 4)      # small test images
    top, bottom = float(s[:, lo].min()), float(s[:, hi].max())
    band = s.flatten()
    band = band[(band <= top) & (band >= bottom)].sort().values
    if len(band) < 2:
        raise AssertionError(f"tflite: no score band between ranks {lo} and {hi}")
    i = int((band[1:] - band[:-1]).argmax())
    return float((band[i] + band[i + 1]) / 2)


def _host_batch(call, host: np.ndarray, times: list):
    """A batch-1 file's outputs over the images of `host`, one call each
    (host ms appended to `times`), stacked on the batch axis."""
    outs = []
    for i in range(len(host)):
        t0 = time.perf_counter()
        outs.append(call(host[i:i + 1]))
        times.append((time.perf_counter() - t0) * 1e3)
    if isinstance(outs[0], dict):
        return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}
    return [np.concatenate([o[j] for o in outs]) for j in range(len(outs[0]))]


def _keep(dec: dict, conf: float, device):
    """batched_nms on the card over "decoded" outputs: (boxes, scores,
    classes, valid, idx)."""
    t = {k: torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v,
                            device=device).float() for k, v in dec.items()}
    scores, classes = yolo_scores(t["obj_logits"][..., 0], t["cls_logits"])
    return batched_nms(t["boxes_xyxy"], scores, classes, iou_th=0.65, conf_th=conf,
                       max_det=300, pre_nms_topk=PRE_NMS_TOPK)


def _same_dets(got, want, masks=None, want_masks=None) -> dict:
    """valid and classes equal, the kept anchors equal where idx is given,
    boxes and scores over TFLITE_FP32_TOL (abs + rel), mask pixel share."""
    got = [torch.as_tensor(np.asarray(g)).cpu() if not isinstance(g, torch.Tensor)
           else g.cpu() for g in got]
    want = [w.cpu() for w in want]
    row = {"valid_equal": bool(torch.equal(got[3].bool(), want[3].bool())),
           "classes_equal": bool(torch.equal(got[2].int(), want[2].int())),
           "dets": int(want[3].sum())}
    if len(got) > 4 and len(want) > 4:
        v = want[3].bool()
        row["keep_equal"] = bool(torch.equal(got[4][v].long(), want[4][v].long()))
    for name, j in (("boxes", 0), ("scores", 1)):
        row[f"{name}_err_over_tol"] = float(((got[j].float() - want[j].float()).abs() / (
            TFLITE_FP32_TOL + TFLITE_FP32_TOL * want[j].float().abs())).max())
    if masks is not None:
        row["mask_share"] = float(((torch.as_tensor(np.asarray(masks)) > 0.5)
                                   != (want_masks.cpu() > 0.5)).float().mean())
    row["ok"] = (row["valid_equal"] and row["classes_equal"] and row.get("keep_equal", True)
                 and row["boxes_err_over_tol"] <= 1 and row["scores_err_over_tol"] <= 1
                 and row.get("mask_share", 0.0) <= SEG_PIXEL_SHARE and row["dets"] > 0)
    return row


def export_tflite_host(card: str, rel: str, ckpt: str, pred, x: torch.Tensor, out_dir: str):
    """The "raw", "decoded" and "nms" `.tflite` files (fp32, batch 1) and the
    fp16 and dynamic "decoded" ones of `ckpt`, each loaded back through
    load_exported and run by the port's runner on the host on the first
    TFLITE_IMAGES images of `x`, against the card's fp32 Predictor `pred`
    (see TFLITE_FP32_TOL); the "decoded" keep through batched_nms on the
    card. Returns the rows and the nms_suppress launches."""
    cpu = _cpu_name()
    t_start = time.perf_counter()
    x2 = x[:TFLITE_IMAGES]
    host = x2.cpu().numpy()
    seg = "seg" in rel
    with torch.inference_mode():
        ref = {"raw": _eager(pred, "raw", x2), "decoded": _eager(pred, "decoded", x2)}
        scores, _ = yolo_scores(ref["decoded"]["obj_logits"][..., 0],
                                ref["decoded"]["cls_logits"])
    conf = _tflite_conf(scores)
    torch.cuda.synchronize()
    cuda_nms.LAUNCHES = 0
    with torch.inference_mode():
        ref_keep = _keep(ref["decoded"], conf, x2.device)
        ref_nms = deploy_export.graph_outputs(pred, pred.forward(x2), "nms", IMG, conf, 0.65,
                                              300)
    rows = {"conf": conf}
    for fmt, q in TFLITE_FILES:
        key = f"{fmt}_{q or 'fp32'}"
        t0 = time.perf_counter()
        path = deploy_export.export_tflite(ckpt, out_dir=os.path.join(out_dir, "tflite", key),
                                           fmt=fmt, batch=1, img_size=IMG,
                                           conf=conf if fmt == "nms" else 0.001, quantize=q)
        export_s = time.perf_counter() - t0
        call, meta = deploy_export.load_exported(path)
        ms = []
        got = _host_batch(call, host, ms)
        row = {"mb": os.path.getsize(path) / 1e6, "export_s": export_s, "host_ms": ms,
               "outputs": meta["outputs"]}
        if fmt == "nms":
            row.update(_same_dets(got[:4], ref_nms[:4], got[4] if seg else None,
                                  ref_nms[4] if seg else None))
        else:
            want = ref[fmt]
            want = list(want.values()) if isinstance(want, dict) else list(want)
            gl = list(got.values()) if isinstance(got, dict) else got
            if isinstance(got, dict) and list(got) != deploy_export.output_names(seg, fmt, 3):
                raise AssertionError(f"tflite {rel} {key}: outputs {list(got)}")
            if q is None:
                row["err_over_tol"] = max(float((np.abs(g - w.float().cpu().numpy()) / (
                    TFLITE_FP32_TOL + TFLITE_FP32_TOL * np.abs(w.float().cpu().numpy())))
                    .max()) for g, w in zip(gl, want))
                row["ok"] = row["err_over_tol"] <= 1
            else:
                pairs = [(torch.from_numpy(g), w.float().cpu()) for g, w in zip(gl, want)]
                row["scale_err"] = max(_scale_err(g, w) for g, w in pairs)
                row["mean_rel_err"] = max(float((g - w).abs().mean() / w.abs().mean())
                                          for g, w in pairs)
                row["ok"] = row["scale_err" if q == "fp16" else "mean_rel_err"] <= \
                    TFLITE_QUANT_TOL[q]
            if fmt == "decoded" and q is None:
                with torch.inference_mode():
                    keep = _keep(got, conf, x2.device)
                row["keep"] = _same_dets(keep, ref_keep)
                row["ok"] = row["ok"] and row["keep"]["ok"]
        torch.cuda.synchronize()
        log(f"export tflite {os.path.basename(rel)} {key}: {row['mb']:.3f} MB, export "
            f"{export_s:.1f} s, host {ms[0]:.1f} / {ms[1]:.1f} ms a {IMG} image (first / "
            f"second call), " + ", ".join(f"{k} {v}" for k, v in row.items()
                                          if k not in ("mb", "export_s", "host_ms",
                                                       "outputs"))
            + f" [{cpu}; {card}]")
        if not row["ok"]:
            raise AssertionError(f"tflite {rel} {key} disagrees with the card's fp32 graph")
        rows[key] = row
    rows["launches"] = cuda_nms.LAUNCHES
    rows["seconds"] = time.perf_counter() - t_start
    log(f"export tflite {os.path.basename(rel)}: conf {conf:.6f}, {rows['launches']} "
        f"nms_suppress launches (predicted {TFLITE_LAUNCHES}), {rows['seconds']:.1f} s for "
        f"{len(TFLITE_FILES)} files [{card}]")
    if rows["launches"] != TFLITE_LAUNCHES:
        raise AssertionError(f"tflite {rel}: {rows['launches']} launches")
    return rows


def export_onnx_host(card: str, ckpt: str, out_dir: str, x: torch.Tensor):
    """edge_n "raw" and "decoded" ONNX (fp32, batch 1) and a dynamic-batch
    "decoded" file, run by the port's numpy runner on the host at batch 1
    and 3 against the card's fp32 artifacts on the same images."""
    from yololite_tpu_torch.deploy.onnx_run import load_onnx
    cpu = _cpu_name()
    out = {}
    ref = {}
    torch.backends.cudnn.allow_tf32 = False
    try:
        for fmt in ("raw", "decoded"):
            call, _ = deploy_export.load_exported(
                os.path.join(out_dir, "float32", f"edge_n_{fmt}.pt2"))
            got = call(x)
            ref[fmt] = [t[:3].float().cpu().numpy()
                        for t in (got.values() if isinstance(got, dict) else got)]
    finally:
        torch.backends.cudnn.allow_tf32 = True
    del call, got
    host = x[:3].cpu().numpy()
    for fmt, dyn in (("raw", False), ("decoded", False), ("decoded", True)):
        t0 = time.perf_counter()
        path = deploy_export.export_onnx(ckpt, out_dir=os.path.join(out_dir, f"onnx_{dyn}"),
                                         fmt=fmt, img_size=IMG, dynamic_batch=dyn)
        export_s = time.perf_counter() - t0
        graph = load_onnx(path)
        for b in ((1, 3) if dyn else (1,)):
            graph(host[:b])                                   # warm-up
            t0 = time.perf_counter()
            outs = graph(host[:b])
            ms = (time.perf_counter() - t0) * 1e3
            err = max(float((np.abs(o - r[:b]) / (ONNX_TOL + ONNX_TOL * np.abs(r[:b]))).max())
                      for o, r in zip(outs, ref[fmt]))
            key = f"{fmt}{'_dynamic' if dyn else ''}_b{b}"
            out[key] = {"host_ms": ms, "mb": os.path.getsize(path) / 1e6,
                        "export_s": export_s, "err_over_tol": err,
                        "nodes": graph.summary()["nodes"]}
            log(f"export onnx {key}: {out[key]['mb']:.2f} MB, {out[key]['nodes']} nodes, "
                f"host {ms:.1f} ms a call of batch {b}, |diff| / (1e-3 + 1e-3 |card|) <= "
                f"{err:.3f} against the card's fp32 {fmt} [{cpu}; {card}]")
            if err > 1.0:
                raise AssertionError(f"ONNX {key} disagrees with the card's fp32 {fmt}")
    return out


# --------------------------------------------------------------------------- #
# quant: the Predictor's deploy variants (int8, s2d), QAT and the host C++
PEAK_INT8_OPS = 1979e12          # H100 SXM dense int8 tensor-core rate
QUANT_BATCHES = 4                # b128 batches a serving run
QUANT_CPU_FRAMES = 4
QUANT_SCORE_TOL = 1e-4           # int8 fp32 card vs CPU: scores of matched boxes
QAT_STEPS = 10
S2D_FP32_RTOL = 1e-4
S2D_BF16_MATCH = 0.99


def _conv_key(mod, x):
    return (tuple(x.shape), mod.out_channels, mod.kernel_size, mod.stride, mod.groups,
            mod.bias is not None)


def _int8_args(mod):
    if mod.depthwise:
        return (mod.w_packed, mod.s_w, mod.bias_f32, mod.stride, mod.padding)
    return (mod.w_packed, mod.s_w, mod.bias_f32, mod.kernel_size, mod.stride, mod.padding)


def _int8_kernel(mod):
    """The wrapper `Int8Conv2d.forward` calls, with its held operands."""
    if mod.depthwise:
        return cuda_int8.conv_depthwise
    return lambda *a: cuda_int8.conv_dense(*a, w_mma=mod.w_mma)


def _int8_bounds(mod, x, out_numel: int):
    """(quantize, conv) least ms on this card's published peaks: each input
    read once, each output written once; the conv's int8 ops from its shapes."""
    n = x.numel()
    q_bytes = n * (x.element_size() + 1) + 4
    taps = mod.kernel_size[0] * mod.kernel_size[1]
    k = taps * (1 if mod.depthwise else mod.in_channels)
    ops = 2.0 * out_numel * k
    c_bytes = n + mod.w_packed.numel() + 8 * mod.out_channels + out_numel * x.element_size()
    conv = max(c_bytes / PEAK_BYTES_S, ops / PEAK_INT8_OPS) * 1e3
    by = "bytes" if c_bytes / PEAK_BYTES_S >= ops / PEAK_INT8_OPS else "operations"
    return q_bytes / PEAK_BYTES_S * 1e3, conv, by


def _check_int8_call(mod, x, timing: bool):
    """Every kernel of one quantized conv call against its plain version:
    x_q, s_x, the int32 accumulators and the output equal. With `timing`,
    the kernels', plain versions' and (1x1 dense) torch._int_mm's ms."""
    q, s = cuda_int8.quantize(x)
    q0, s0 = cuda_int8.quantize_reference(x)
    kernel = _int8_kernel(mod)
    plain = (cuda_int8.conv_depthwise_reference if mod.depthwise
             else cuda_int8.conv_dense_reference)
    args = _int8_args(mod)
    acc, acc0 = kernel(q, s, *args, torch.int32), plain(q, s, *args, torch.int32)
    out, out0 = kernel(q, s, *args, x.dtype), plain(q, s, *args, x.dtype)
    torch.cuda.synchronize()
    same = {"x_q": torch.equal(q, q0), "s_x": torch.equal(s, s0),
            "acc": torch.equal(acc, acc0), "out": torch.equal(out, out0)}
    if not all(same.values()):
        raise AssertionError(f"int8 kernels differ from their plain versions at "
                             f"{_conv_key(mod, x)}: {same}")
    row = {"shape": list(x.shape), "cout": mod.out_channels, "kernel": list(mod.kernel_size),
           "stride": list(mod.stride), "depthwise": bool(mod.depthwise),
           "quantize_err": float((q.int() - q0.int()).abs().max()),
           "conv_err": max(float((acc - acc0).abs().max()),
                           float((out.float() - out0.float()).abs().max()))}
    if timing:
        bq, bc, by = _int8_bounds(mod, x, out.numel())
        plan = cuda_int8.quantize_plan(x)
        row.update(quantize_ms=cuda_ms(lambda: cuda_int8.quantize(x), 5),
                   quantize_plain_ms=cuda_ms(lambda: cuda_int8.quantize_reference(x), 2, 1),
                   # one read of x for the same max: a yardstick for phase 1
                   # alone, not a library time for the whole function
                   quantize_yardstick_ms=cuda_ms(
                       lambda: torch.linalg.vector_norm(x, float("inf")), 5),
                   quantize_plan={"route": plan.route, "grid": plan.grid, "vec": plan.vec,
                                  "block_elems": plan.block_elems},
                   conv_ms=cuda_ms(lambda: kernel(q, s, *args, x.dtype), 5),
                   conv_plain_ms=cuda_ms(lambda: plain(q, s, *args, x.dtype), 1, 1),
                   quantize_bound_ms=bq, conv_bound_ms=bc, conv_bound_by=by, library_ms=None)
        if not mod.depthwise and mod.kernel_size == (1, 1) and mod.stride == (1, 1):
            m, c = x.shape[0] * x.shape[2] * x.shape[3], x.shape[1]
            if m > 16 and c % 8 == 0 and mod.out_channels % 8 == 0:
                a2 = q.permute(0, 2, 3, 1).reshape(m, c)
                b2 = mod.w_packed[:, :c].contiguous().t()
                if not torch.equal(torch._int_mm(a2, b2), acc.permute(0, 2, 3, 1).reshape(m, -1)):
                    raise AssertionError("torch._int_mm disagrees with the int32 accumulators")
                row["library_ms"] = cuda_ms(lambda: torch._int_mm(a2, b2), 5)
        log(f"quantize {tuple(x.shape)} {str(x.dtype)[6:]} [{plan.route}, grid {plan.grid}, "
            f"vec {plan.vec}]: {row['quantize_ms']:.4f} ms, bound {bq:.4f} (bytes), "
            f"vector_norm(inf) {row['quantize_yardstick_ms']:.4f} (yardstick: the max pass "
            f"alone)")
    del q, q0, acc, acc0, out, out0
    return row


def check_int8_model(pred, batch: torch.Tensor, timing: bool):
    """Run the int8 Predictor's forward once on `batch` (on the card) and
    hold every distinct quantized conv call against the plain versions.
    A uint8 `batch` goes through `Predictor.forward`; a floating one is the
    model's own input (as evaluate's Trainer feeds it) and goes to
    `pred.model` as it is. Returns (rows by distinct call, calls per
    forward by key)."""
    rows, calls = {}, {}

    def hook(mod, args):
        x = args[0]
        if not quant.should_quantize(x):
            return
        key = _conv_key(mod, x)
        calls[key] = calls.get(key, 0) + 1
        if key not in rows:
            rows[key] = _check_int8_call(mod, x, timing)

    hooks = [m.register_forward_pre_hook(hook) for m in pred.model.modules()
             if isinstance(m, quant.Int8Conv2d)]
    try:
        with torch.inference_mode():
            if batch.is_floating_point():
                pred.model(batch)
            else:
                pred.forward(batch)
    finally:
        for h in hooks:
            h.remove()
    torch.cuda.empty_cache()
    return rows, calls


def _kernel_totals(rows, calls):
    """Per kernel, the sums over one b128 forward's quantized conv calls."""
    tot = {name: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=None, ms_1x1=None,
                      ops_bound=0, calls=0, max_abs_err=0.0) for name in cuda_int8.KERNEL_NAMES}
    tot["int8_quantize"]["yardstick_ms"] = 0.0
    for key, r in rows.items():
        n = calls[key]
        conv = "int8_conv_depthwise" if r["depthwise"] else "int8_conv_dense"
        for name, ms, plain, bound, err in (
                ("int8_quantize", r["quantize_ms"], r["quantize_plain_ms"], r["quantize_bound_ms"],
                 r["quantize_err"]),
                (conv, r["conv_ms"], r["conv_plain_ms"], r["conv_bound_ms"], r["conv_err"])):
            t = tot[name]
            t["max_abs_err"] = max(t["max_abs_err"], err)
            t["ms"] += n * ms
            t["plain_ms"] += n * plain
            t["bound_ms"] += n * bound
            t["calls"] += n
        tot[conv]["ops_bound"] += n * (r["conv_bound_by"] == "operations")
        tot["int8_quantize"]["yardstick_ms"] += n * r["quantize_yardstick_ms"]
        if r["library_ms"] is not None:
            t = tot["int8_conv_dense"]
            t["library_ms"] = (t["library_ms"] or 0.0) + n * r["library_ms"]
            t["ms_1x1"] = (t["ms_1x1"] or 0.0) + n * r["conv_ms"]
    for name, t in tot.items():
        t["bound_by"] = ("bytes" if name == "int8_quantize" or t["ops_bound"] * 2 < t["calls"]
                         else "operations")
    return tot


# graph calls _kernel_ms makes before its profiled ones: one warm call and
# one traced by the profiler but not kept (its first kernels' records can
# be lost while the tracer starts)
PROFILE_WARM_CALLS = 2


def _kernel_ms(pred, x, kw, iters: int = 3, counts=None):
    """torch.profiler over `iters` b128 graph calls: device ms a call by
    kernel name (and, into `counts`, device launches a call by name)."""
    from torch.profiler import ProfilerActivity, profile, schedule
    with torch.inference_mode():
        pred.postprocess(pred.forward(x), IMG, **kw)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=PROFILE_WARM_CALLS - 1, active=iters,
                                       repeat=1)) as prof:
            for i in range(PROFILE_WARM_CALLS - 1 + iters):
                pred.postprocess(pred.forward(x), IMG, **kw)
                if i in (PROFILE_WARM_CALLS - 2, PROFILE_WARM_CALLS - 2 + iters):
                    torch.cuda.synchronize()    # the kept calls run back to back
                prof.step()
    out = {}
    for e in prof.key_averages():
        # the schedule's step annotations carry the steps' device span
        if str(getattr(e, "device_type", "")).endswith("CUDA") and \
                not e.key.startswith("ProfilerStep"):
            out[e.key] = out.get(e.key, 0.0) + e.self_device_time_total / 1e3 / iters
            if counts is not None:
                counts[e.key] = counts.get(e.key, 0) + e.count / iters
    return out


def _stage_split(pred, x, kw, card: str):
    """Device ms a b128 call in the int8 quantize, the int8 convs
    (each kernel's CUDA symbols, `cuda_int8.KERNEL_SYMBOLS`), cuDNN's convs,
    BatchNorm and activations, and the rest (adds, upsampling, decode, NMS),
    by kernel name. Raises when the profiled calls launched an int8 kernel
    under which the profile filed no time, or when the profile shows more
    quantize kernels a call than launches, or any memset."""
    stage = {"int8_quantize": "int8 quantize", "int8_conv_dense": "int8 conv dense",
             "int8_conv_depthwise": "int8 conv depthwise"}
    split = dict.fromkeys((*stage.values(), "cuDNN conv", "BN/activation", "rest"), 0.0)
    cuda_int8.reset_launches()
    counts, iters = {}, 3
    by_kernel = _kernel_ms(pred, x, kw, iters, counts)
    launched = dict(cuda_int8.LAUNCHES)
    for k, ms in by_kernel.items():
        int8 = [n for n, syms in cuda_int8.KERNEL_SYMBOLS.items() if any(s in k for s in syms)]
        if int8:
            split[stage[int8[0]]] += ms
        elif any(s in k.lower() for s in ("conv", "implicit", "cudnn", "xmma", "sm90")):
            split["cuDNN conv"] += ms
        elif any(a in k.lower() for a in ("batch_norm", "bn_", "clamp", "threshold",
                                          "relu", "silu", "hardswish", "gelu")):
            split["BN/activation"] += ms
        else:
            split["rest"] += ms
    log(f"quant stages (profiler, device ms per b{BATCH} call): "
        + ", ".join(f"{k} {v:.3f}" for k, v in split.items()) + f" [{card}]")
    # one device operation a quantize call: no more kernels under its symbols
    # than launches (the tracer may lose a record, never add one), and no
    # memset anywhere in the graph
    syms = cuda_int8.KERNEL_SYMBOLS["int8_quantize"]
    q_kernels = sum(c for k, c in counts.items() if any(s in k for s in syms))
    q_launches = launched["int8_quantize"] / (PROFILE_WARM_CALLS + iters)
    memsets = sum(c for k, c in counts.items() if "memset" in k.lower())
    log(f"quant profile a b{BATCH} call: {q_kernels:g} quantize kernels, {q_launches:g} "
        f"quantize launches, {memsets:g} memsets in the whole graph [{card}]")
    if q_kernels > q_launches or memsets:
        raise AssertionError(f"{q_kernels} quantize kernels and {memsets} memsets a call in "
                             f"the profile, {q_launches} quantize launches")
    missing = [n for n in stage if launched[n] and not split[stage[n]] > 0]
    if missing:
        raise AssertionError(f"int8 kernels {missing} launched {launched} times in the "
                             f"profiled calls but no kernel time was filed under their "
                             f"symbols {[cuda_int8.KERNEL_SYMBOLS[n] for n in missing]}")
    return split


def _serve_turns(preds, batches, kw, order):
    """img/s of infer_batched_stream (prepared, depth 2) over QUANT_BATCHES
    batches, from each Predictor's device batches and host batches
    (`batches[name]["device"|"host"]`), in the given turns. The launch
    counts are set to 0 before each turn and summed per Predictor after it,
    so each Predictor's count holds its own launches only."""
    out = {name: {"device": [], "host": []} for name in preds}
    launches = {name: dict.fromkeys((*cuda_int8.KERNEL_NAMES, "nms_suppress"), 0)
                for name in preds}
    for name in order:
        pred = preds[name]
        for src in ("device", "host"):
            src_batches = batches[name][src]
            torch.cuda.synchronize()
            cuda_int8.reset_launches()
            cuda_nms.LAUNCHES = 0
            t0 = time.perf_counter()
            for _ in pred.infer_batched_stream(
                    (src_batches[i % 2] for i in range(QUANT_BATCHES)),
                    prepared=True, depth=2, **kw):
                pass
            out[name][src].append(QUANT_BATCHES * BATCH / (time.perf_counter() - t0))
            for k, v in dict(cuda_int8.LAUNCHES, nms_suppress=cuda_nms.LAUNCHES).items():
                launches[name][k] += v
    return out, launches


def _score_gap(card_dets, cpu_dets, box_tol):
    """Largest, over card detections with a CPU detection of the same class
    and box within box_tol px, of the smallest score difference to one."""
    gap = 0.0
    for (b, s, c), (cb, cs, cc) in zip(card_dets, cpu_dets):
        for i in range(len(b)):
            same = (cc == c[i]) & (np.abs(cb - b[i]).max(-1) <= box_tol)
            if same.any():
                gap = max(gap, float(np.abs(cs[same] - s[i]).min()))
    return gap


def _dets(pred, x, kw):
    with torch.inference_mode():
        return [t.cpu() for t in pred.postprocess(pred.forward(pred._upload(x)), IMG, **kw)[:4]]


def quant_int8(card: str, model, meta, host, dev, kw):
    """int8 serving of edge_n at b128: kernels against plain versions at every
    distinct quantized conv call (timed), launches in the serving window,
    img/s beside bf16 in turns, the stage split, peak memory, the share of
    int8 detections found by bf16, and the card's fp32 int8 against the CPU's."""
    weights = (model, model.state_dict(), meta)
    pred8 = Predictor(weights, device="cuda", dtype=torch.bfloat16, quantize="int8")
    predbf = Predictor(weights, device="cuda", dtype=torch.bfloat16)
    rows, calls = check_int8_model(pred8, dev[0], timing=True)
    tot = _kernel_totals(rows, calls)
    log(f"quant int8 edge_n b{BATCH}: {len(rows)} distinct quantized conv calls "
        f"({sum(calls.values())} a forward), kernels equal their plain versions "
        f"(x_q, s_x, int32 accumulators, bf16 output) [{card}]")
    for name, t in tot.items():
        log(f"kernel {name}: {t['ms']:.3f} ms a b{BATCH} forward over {t['calls']} calls, "
            f"bound {t['bound_ms']:.3f} ms ({t['bound_by']}), plain {t['plain_ms']:.3f} ms"
            + (f", 1x1 calls {t['ms_1x1']:.3f} ms vs torch._int_mm {t['library_ms']:.3f} ms"
               if t["library_ms"] is not None else "") + f" [{card}]")
    for p in (pred8, predbf):           # the b128 graphs' first calls, not timed
        list(p.infer_batched_stream([dev[0], host[0]], prepared=True, **kw))
    order = ("bf16", "int8", "int8", "bf16")
    ips, by_pred = _serve_turns({"bf16": predbf, "int8": pred8},
                                dict.fromkeys(order, {"device": dev, "host": host}), kw, order)
    launches = by_pred["int8"]
    # the int8 turns' graph calls: 2 turns x (device, host) x QUANT_BATCHES;
    # each launches nms_suppress once and every kernel once per call of it
    graph_calls = order.count("int8") * 2 * QUANT_BATCHES
    want = dict({k: graph_calls * t["calls"] for k, t in tot.items()},
                nms_suppress=graph_calls)
    log(f"quant serve launches, int8 turns: {launches} (want {want}); bf16 turns: "
        f"{by_pred['bf16']}")
    if launches != want or min(launches.values()) == 0:
        raise AssertionError(f"the int8 serving path launched {launches}, not {want}")
    if any(by_pred["bf16"][k] for k in cuda_int8.KERNEL_NAMES):
        raise AssertionError(f"the bf16 Predictor launched int8 kernels: {by_pred['bf16']}")
    for name, r in ips.items():
        log(f"quant serve {name} b{BATCH}: img/s from device batches "
            f"{', '.join(f'{v:.1f}' for v in r['device'])}; from host uint8 batches "
            f"{', '.join(f'{v:.1f}' for v in r['host'])} [{card}]")
    x = dev[0]
    with torch.inference_mode():
        graph = {name: cuda_ms(lambda p=p: p.postprocess(p.forward(x), IMG, **kw), 5)
                 for name, p in (("bf16", predbf), ("int8", pred8))}
        fwd = {name: cuda_ms(lambda p=p: p.forward(x), 5)
               for name, p in (("bf16", predbf), ("int8", pred8))}
    stages = _stage_split(pred8, x, kw, card)
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        pred8.postprocess(pred8.forward(x), IMG, **kw)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 1e9
    share, n = _iou_matched(_dets(predbf, x, kw), _dets(pred8, x, kw), 0.5)
    log(f"quant graph b{BATCH}: whole graph int8 {graph['int8']:.3f} ms, bf16 "
        f"{graph['bf16']:.3f} ms; forward int8 {fwd['int8']:.3f} ms, bf16 {fwd['bf16']:.3f} "
        f"ms; int8 peak {peak:.2f} GB; {share:.4f} of {n} int8 detections found by bf16 "
        f"(same class, IoU >= 0.5; the quantization error, not held) [{card}]")
    # the card's fp32 int8 Predictor against the CPU's on a few frames
    torch.backends.cudnn.allow_tf32 = False
    try:
        g32 = Predictor(weights, device="cuda", dtype=torch.float32, quantize="int8")
        c32 = Predictor(weights, device="cpu", dtype=torch.float32, quantize="int8")
        frames = host[0][:QUANT_CPU_FRAMES]
        # the CPU keeps 3x as many: the seeded heads' top 100 scores lie
        # close together (their spread is logged below), so a one-level
        # flip may move a detection across the card's max_det cut
        dg = [g32.infer_image(f[..., ::-1], conf=0.001, max_det=100) for f in frames]
        dc = [c32.infer_image(f[..., ::-1], conf=0.001, max_det=300) for f in frames]
    finally:
        torch.backends.cudnn.allow_tf32 = True
    frac, total = _match(dg, dc, 1.0, QUANT_SCORE_TOL)
    gap = _score_gap(dg, dc, 1.0)
    spread = max(float(s.max() - s.min()) for _, s, _ in dg)
    log(f"quant int8 fp32 card vs CPU on {len(frames)} frames: {frac:.4f} of the card's "
        f"{total} top-100 detections among the CPU's top 300 (same class, boxes within "
        f"1 px, scores within {QUANT_SCORE_TOL}; need >= 0.99); largest score difference "
        f"of a box match {gap:.3e}, the card's top-100 score spread {spread:.3e}")
    if total == 0 or frac < 0.99:
        raise AssertionError("int8 fp32 card and CPU detections disagree")
    return {"rows": list(rows.values()), "totals": tot, "launches": launches, "img_s": ips,
            "graph_ms": graph, "forward_ms": fwd, "stages_ms": stages, "peak_gb": peak,
            "bf16_match": share, "dets": n, "cpu_match": frac, "cpu_score_gap": gap}


def quant_shapes(card: str, dev):
    """Kernels against plain versions at every distinct quantized conv call of
    edge_n_seg at b128 and of every other detection config at b2 (@640)."""
    counts = {}
    seg_rel = "configs/models/edge_n_seg.yaml"
    cfg = _seg_config(seg_rel)
    seg = _seg_model(seg_rel, cfg, dev[0][:8])
    meta = {"img_size": IMG, "names": ["c0", "c1", "c2"]}
    pred = Predictor((seg, seg.state_dict(), meta), device="cuda", quantize="int8")
    rows, _ = check_int8_model(pred, dev[0], timing=False)
    counts["edge_n_seg_b128"] = len(rows)
    kw = dict(conf=0.001, iou=0.45, max_det=300)
    with torch.inference_mode():
        out = pred.postprocess(pred.forward(dev[0]), IMG, **kw)
        seg_ms = cuda_ms(lambda: pred.postprocess(pred.forward(dev[0]), IMG, **kw), 3)
    if not (torch.isfinite(out[4]).all() and out[4].shape[:2] == (BATCH, 300)):
        raise AssertionError("edge_n_seg int8: masks not finite / not [B, max_det, ...]")
    log(f"quant edge_n_seg int8 b{BATCH}: finite masks {tuple(out[4].shape)}, whole graph "
        f"{seg_ms:.3f} ms [{card}]")
    del pred, out
    for rel, cfg in zoo_configs():
        if rel.endswith("/edge_n.yaml"):
            continue
        model = init_weights(build_model_from_config(cfg), 0).eval()
        pred = Predictor((model, model.state_dict(), meta), device="cuda", quantize="int8")
        rows, _ = check_int8_model(pred, dev[0][:2], timing=False)
        counts[rel] = len(rows)
        del pred, model
    torch.cuda.empty_cache()
    log(f"quant shapes: kernels equal their plain versions at {sum(counts.values())} "
        f"distinct quantized conv calls ({counts}) [{card}]")
    return {"distinct_calls": counts, "seg_graph_ms": seg_ms}


def quant_qat(card: str, data: str, tmp: str):
    """QAT_STEPS steps of edge_n b8 @640 bf16 with training.qat, beside the
    plain step; an int8 Predictor serves the QAT checkpoint."""
    out = {}
    batch = _first_batch(_edge_n_train_config(data, amp=True))
    for qat in (False, True, True, False):
        cfg = _edge_n_train_config(data, amp=True)
        cfg["training"]["qat"] = qat
        params, stats = _seeded_flax_edge_n(cfg)
        trainer = Trainer(build_model_from_config(cfg), cfg, total_updates=100, device="cuda")
        state = trainer.state_from_weights(params, stats)
        start = [p.detach().clone() for p in state.params]
        b = trainer.put_batch(batch)
        lr = trainer.lr_vector(1e-3)
        losses = []
        trainer.train_step(state, b, lr)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(QAT_STEPS - 1):
            _, m = trainer.train_step(state, b, lr)
            losses.append(m["total"])
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / (QAT_STEPS - 1)
        losses = [float(v) for v in losses]
        moved = max(float((p.detach() - s).abs().max()) for p, s in zip(state.params, start))
        if not (np.isfinite(losses).all() and moved > 0):
            raise AssertionError(f"qat={qat}: losses {losses}, moved {moved}")
        out.setdefault("qat" if qat else "plain", []).append(step_ms)
        if qat and "ckpt" not in out:
            if trainer.qat is not True or not isinstance(
                    state.model.backbone.ConvBNAct_0.Conv_0, quant.FakeQuantConv2d):
                raise AssertionError("training.qat did not make fake-quant convs")
            p, bs = to_flax(trainer.ema_variables(state))
            out["ckpt"] = save_checkpoint(os.path.join(tmp, "qat.ckpt"), p, bs,
                                          build_meta(cfg, {}, "map", ["c0", "c1", "c2"],
                                                     (1, 1, 1)))
            out["losses"] = losses
        del trainer, state
    pred = Predictor(out["ckpt"], device="cuda", quantize="int8")
    res = list(pred.infer_batched_stream([batch["image"]], prepared=True, conf=0.001))
    if len(res[0]) != len(batch["image"]) or not all(np.isfinite(r["boxes"]).all()
                                                    for r in res[0]):
        raise AssertionError("the int8 Predictor did not serve the QAT checkpoint")
    log(f"quant qat edge_n b8 @{IMG} bf16: step ms plain {out['plain']}, QAT {out['qat']} "
        f"(host clock, synced, {QAT_STEPS - 1} steps each); losses {out['losses'][:3]}... "
        f"finite, parameters move; the int8 Predictor serves its checkpoint [{card}]")
    return {k: v for k, v in out.items() if k != "ckpt"}


def quant_s2d(card: str, model, meta, host, dev, kw):
    """s2d against the folded Predictor: fp32 outputs, bf16 detections, img/s
    in turns (packed device batches, host batches with the pack), host pack ms."""
    weights = (model, model.state_dict(), meta)
    torch.backends.cudnn.allow_tf32 = False
    try:
        s32 = Predictor(weights, device="cuda", dtype=torch.float32, s2d_stem=True)
        f32 = Predictor(weights, device="cuda", dtype=torch.float32)
        x = dev[0][:8]
        with torch.inference_mode():
            err = max(_scale_err(a, b) for a, b in zip(s32.forward(s32._upload(x)),
                                                        f32.forward(x)))
    finally:
        torch.backends.cudnn.allow_tf32 = True
    del s32, f32
    s2d_p = Predictor(weights, device="cuda", dtype=torch.bfloat16, s2d_stem=True)
    fold = Predictor(weights, device="cuda", dtype=torch.bfloat16)
    if not (s2d_p.s2d and isinstance(s2d_p.model.backbone.ConvBNAct_0.Conv_0,
                                     deploy_s2d.S2DStemConv)):
        raise AssertionError("s2d_stem=True did not rewrite the stem")
    match, n = _iou_matched(_dets(s2d_p, dev[0], kw), _dets(fold, dev[0], kw), 0.99)
    log(f"quant s2d: fp32 outputs vs folded {err:.3e} of their scale (need <= "
        f"{S2D_FP32_RTOL}); bf16 {match:.4f} of {n} folded detections matched at IoU 0.99 "
        f"(need >= {S2D_BF16_MATCH}) [{card}]")
    if err > S2D_FP32_RTOL or match < S2D_BF16_MATCH or n == 0:
        raise AssertionError("s2d Predictor disagrees with the folded one")
    packed_dev = [deploy_s2d.pack_s2d_device(d) for d in dev]
    t0 = time.perf_counter()
    packed_host = deploy_s2d.pack_s2d(host[0])
    pack_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    plain = native.pack_s2d_plain(host[0])
    pack_plain_ms = (time.perf_counter() - t0) * 1e3
    if not (np.array_equal(packed_host, plain)
            and np.array_equal(packed_dev[0].cpu().numpy(), plain)):
        raise AssertionError("s2d packs (C++, numpy, device) disagree")
    list(s2d_p.infer_batched_stream([packed_dev[0], host[0]], prepared=True, **kw))
    list(fold.infer_batched_stream([dev[0], host[0]], prepared=True, **kw))
    ips, _ = _serve_turns({"folded": fold, "s2d": s2d_p},
                          {"folded": {"device": dev, "host": host},
                           "s2d": {"device": packed_dev, "host": host}},
                          kw, ("folded", "s2d", "s2d", "folded"))
    with torch.inference_mode():
        graph = {"s2d": cuda_ms(lambda: s2d_p.postprocess(s2d_p.forward(packed_dev[0]), IMG,
                                                          **kw), 5),
                 "folded": cuda_ms(lambda: fold.postprocess(fold.forward(dev[0]), IMG, **kw), 5)}
    # where the graphs differ: device ms a call by kernel, s2d minus folded
    ks, kf = _kernel_ms(s2d_p, packed_dev[0], kw), _kernel_ms(fold, dev[0], kw)
    diff = {k: ks.get(k, 0.0) - kf.get(k, 0.0) for k in set(ks) | set(kf)}
    top = sorted(diff.items(), key=lambda kv: -abs(kv[1]))[:6]
    log(f"quant s2d profile (device ms a b{BATCH} call): s2d {sum(ks.values()):.3f}, folded "
        f"{sum(kf.values()):.3f}; largest differences by kernel: "
        + "; ".join(f"{k[:90]} {ks.get(k, 0.0):.3f} vs {kf.get(k, 0.0):.3f}" for k, _ in top)
        + f" [{card}]")
    for name, r in ips.items():
        log(f"quant s2d serve {name} b{BATCH}: img/s from device batches "
            f"{', '.join(f'{v:.1f}' for v in r['device'])}; from host batches "
            f"{', '.join(f'{v:.1f}' for v in r['host'])} [{card}]")
    log(f"quant s2d graph b{BATCH}: s2d {graph['s2d']:.3f} ms, folded {graph['folded']:.3f} "
        f"ms; host pack of b{BATCH} @{IMG}: C++ {pack_ms:.1f} ms, numpy {pack_plain_ms:.1f} "
        f"ms [{card}; {_cpu_name()}]")
    return {"fp32_err": err, "bf16_match": match, "dets": n, "img_s": ips, "graph_ms": graph,
            "pack_ms": pack_ms, "pack_plain_ms": pack_plain_ms,
            "profile_diff_ms": {k: [ks.get(k, 0.0), kf.get(k, 0.0)] for k, _ in top}}


def _match_pairs(seed: int, n_images: int, n_cls: int, n_dets: int):
    """Seeded COCO matcher inputs: for each of n_images, 1-15 ground truths
    (5% ignored, sorted last) and n_dets detections (half jittered copies of
    the ground truths, 80% of their class), split into (image, category)
    pairs of [D,G] IoU matrices with the detections by descending score."""
    from yololite_tpu_torch.eval.coco import iou_xywh_matrix
    rng = np.random.RandomState(seed)
    pairs = []
    for _ in range(n_images):
        g = rng.randint(1, 16)
        gt = np.concatenate([rng.rand(g, 2) * (IMG - 80), rng.rand(g, 2) * 120 + 8], 1)
        gc = rng.randint(0, n_cls, g)
        src = rng.randint(0, g, n_dets)
        dt = gt[src] + rng.randn(n_dets, 4) * np.array([6.0, 6.0, 8.0, 8.0])
        dt[n_dets // 2:, :2] = rng.rand(n_dets - n_dets // 2, 2) * (IMG - 80)
        dt[:, 2:] = np.maximum(dt[:, 2:], 2.0)
        dc = np.where(rng.rand(n_dets) < 0.8, gc[src], rng.randint(0, n_cls, n_dets))
        sc = rng.rand(n_dets)
        ig = rng.rand(g) < 0.05
        for c in range(n_cls):
            d, k = np.where(dc == c)[0], np.where(gc == c)[0]
            if len(d) and len(k):
                d = d[np.argsort(-sc[d], kind="stable")]
                k = k[np.argsort(ig[k], kind="stable")]
                pairs.append((iou_xywh_matrix(dt[d], gt[k]), ig[k]))
    return pairs


def quant_native(card: str, data: str, model, meta, dev, tmp: str):
    """The host C++ matcher against the Python one: alone, timed, on seeded
    pairs of a 5,000-image validation set, and in evaluate_model on the val
    set (equal stats; its time is the eval forward's, a check only); and
    nms_numpy on one "decoded" output."""
    from yololite_tpu_torch.eval.coco import IOU_THRS
    t0 = time.perf_counter()
    pairs = _match_pairs(0, 5000, 3, 100)
    gen_s = time.perf_counter() - t0
    match_s, got = {}, {}
    for name, fn in (("cpp", native.coco_match), ("python", native.coco_match_plain)):
        fn(*pairs[0], IOU_THRS)
        t0 = time.perf_counter()
        got[name] = [fn(ious, ig, IOU_THRS) for ious, ig in pairs]
        match_s[name] = time.perf_counter() - t0
    if not all(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
               for a, b in zip(got["cpp"], got["python"])):
        raise AssertionError("coco_match (C++) differs from its plain version")
    d_mean = float(np.mean([p[0].shape[0] for p in pairs]))
    g_mean = float(np.mean([p[0].shape[1] for p in pairs]))
    log(f"quant native matcher: {len(pairs)} (image, category) pairs of 5,000 seeded images "
        f"x 100 detections (mean D {d_mean:.1f}, G {g_mean:.2f}, 10 thresholds; made in "
        f"{gen_s:.2f} s): C++ {match_s['cpp']:.3f} s, Python {match_s['python']:.3f} s, "
        f"matches equal [{_cpu_name()}]")
    n_pairs = len(pairs)
    del pairs, got
    cfg = _edge_n_train_config(data, amp=True)
    trainer = Trainer(build_model_from_config(cfg), cfg, device="cuda")
    variables = copy.deepcopy(model).cuda().to(memory_format=torch.channels_last).eval()
    mb = int(cfg["training"]["max_boxes"])
    val_ds = YoloDataset(cfg["dataset"]["val_images"], cfg["dataset"]["val_labels"],
                         img_size=IMG, is_train=False, augment=False, max_boxes=mb)
    loader = DataLoader(val_ds, 8, shuffle=False, drop_last=False)
    res, secs = {}, {}
    real = native.coco_match
    # the first pass pays the eval graph's first-call costs; it is not timed
    for name, matcher in (("warm-up", real), ("cpp", real), ("python", native.coco_match_plain)):
        native.coco_match = matcher
        try:
            t0 = time.perf_counter()
            res[name] = evaluate_model(trainer, variables, loader, os.path.join(tmp, name), 3,
                                       IMG, run_bench=False)
            secs[name] = time.perf_counter() - t0
        finally:
            native.coco_match = real
    diff = max(abs(res["cpp"]["coco"][k] - res["python"]["coco"][k]) for k in res["cpp"]["coco"])
    if diff > 1e-12:
        raise AssertionError(f"evaluate_model: C++ and Python matchers differ by {diff}")
    pred = Predictor((model, model.state_dict(), meta), device="cuda")
    out = _eager(pred, "decoded", dev[0][:1])
    t0 = time.perf_counter()
    for _ in range(5):
        boxes, _, _, _ = deploy_infer_exported.postprocess_decoded(out, 0.001, 0.45, 300)
    post_ms = (time.perf_counter() - t0) * 1e3 / 5
    box = out["boxes_xyxy"][0].float().cpu().numpy()
    sc = torch.sigmoid(out["obj_logits"][0, :, 0].float()).cpu().numpy()
    t0 = time.perf_counter()
    keep = nms_numpy(box, sc, 0.45)
    nms_ms = (time.perf_counter() - t0) * 1e3
    if not np.array_equal(keep, native.nms_plain(box, sc, 0.45)):
        raise AssertionError("nms_numpy (C++) differs from its plain version")
    log(f"quant native: evaluate_model on {len(val_ds)} val images, C++ matcher "
        f"{secs['cpp']:.3f} s, Python {secs['python']:.3f} s (the eval forward's time, a "
        f"check only), stats equal (max diff {diff}); "
        f"nms_numpy over all {len(box)} anchors of one decoded output {nms_ms:.2f} ms "
        f"({len(keep)} kept); host post-processing of the decoded output {post_ms:.2f} ms "
        f"[{_cpu_name()}]")
    return {"match_s": match_s, "match_pairs": {"n": n_pairs, "mean_d": d_mean,
                                                "mean_g": g_mean},
            "evaluate_s": secs, "max_diff": diff, "nms_ms": nms_ms, "anchors": len(box),
            "postprocess_ms": post_ms}


def phase_quant(card: str, data: str, tmp: str):
    model = _edge_n_model()
    meta = {"img_size": IMG, "names": ["c0", "c1", "c2"]}
    rng = np.random.RandomState(9)
    host = [(rng.rand(BATCH, IMG, IMG, 3) * 255).astype(np.uint8) for _ in range(2)]
    dev = [torch.from_numpy(h).cuda() for h in host]
    kw = dict(conf=0.001, iou=0.45, max_det=300)
    out = {}
    for name, fn in (("int8", lambda: quant_int8(card, model, meta, host, dev, kw)),
                     ("shapes", lambda: quant_shapes(card, dev)),
                     ("qat", lambda: quant_qat(card, data, tmp)),
                     ("s2d", lambda: quant_s2d(card, model, meta, host, dev, kw)),
                     ("native", lambda: quant_native(card, data, model, meta, dev, tmp))):
        t0 = time.perf_counter()
        out[name] = fn()
        log(f"quant {name}: {time.perf_counter() - t0:.1f} s")
        torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------- #
# cli: every command-line tool of the port, in-process on the card
# --------------------------------------------------------------------------- #
CLI_CONF = 0.001                 # low enough that a 1-epoch model detects
CLI_TRACK_FRAMES = 60
# evaluate --quantize int8 against bf16 on the same checkpoint: every COCO
# stat within this (absolute), a bound set beforehand for dynamic int8 with
# one scale a tensor, not a measured one
CLI_INT8_STAT_TOL = 0.05
# and only the stats over all labels: each size-split stat rests on a few
# labels, where one reordered detection moves it by more than the bound
CLI_INT8_STATS = ("AP", "AP50", "AP75", "AR")
# evaluate runs on the best checkpoint with its heads' obj and cls logits
# (less their biases) scaled to this standard deviation over the val images:
# the 1-epoch model's scores are nearly flat (300 detections an image at conf
# 0.001, ties among the best), so that any rounding reorders them
CLI_LOGIT_STD = 2.0
# the val images are labelled with the bf16 Predictor's own best detections
# (the model scores AP 0 on the set's labels); bf16's AP50 on them must reach
# CLI_MIN_AP50, so that the int8 comparison cannot hold at 0
CLI_LABELS_PER_IMAGE = 5
CLI_MIN_AP50 = 0.3


def _result_dets(r):
    return [(np.asarray(r["boxes"]), np.asarray(r["scores"]), np.asarray(r["classes"]))]


def _cli_train(card: str, data: str, work: str, secs: dict, launches: dict):
    argv = ["--model", os.path.join(ROOT, "configs", "models", "edge_n.yaml"),
            "--train", os.path.join(ROOT, "configs", "train", "standard_train.yaml"),
            "--data", data, "--epochs", "1", "--batch_size", "8", "--img_size", str(IMG),
            "--workers", "8", "--pretrained_backbone", BACKBONE_CKPT, "--data_parallel", "1"]
    torch.cuda.synchronize()
    cuda_nms.LAUNCHES = 0
    t0 = time.perf_counter()
    res = cli_train.main(argv)
    torch.cuda.synchronize()
    secs["train"], launches["train"] = time.perf_counter() - t0, cuda_nms.LAUNCHES
    val_batches = -(-VAL_N // 8)
    _check_run_dir(res["log_dir"])
    hist = res["history"]
    log(f"cli train: 1 epoch of edge_n @{IMG} b8 (standard_train.yaml, the bundled "
        f"backbone) in {secs['train']:.1f} s; train loss {hist['train_loss'][0]:.4f}, val "
        f"loss {hist['val_loss'][0]:.4f}; nms_suppress launched {launches['train']} times "
        f"(expected {2 * val_batches}: {val_batches} val batch + {val_batches} in "
        f"evaluate_model) [{card}]")
    if launches["train"] != 2 * val_batches:
        raise AssertionError("cli train: validation did not go through the kernel")
    if not all(np.isfinite(hist["step_loss"] + hist["val_loss"])):
        raise AssertionError(f"cli train: non-finite loss {hist}")
    if not res["log_dir"].startswith(work):
        raise AssertionError(f"cli train: run dir {res['log_dir']} outside {work}")
    return os.path.join(res["log_dir"], "weights", "best_model_state.ckpt")


def _sharpened(best: str, data: str, path: str) -> str:
    """`best` with each head's obj and cls kernels scaled so that the
    logits they add to their biases have standard deviation CLI_LOGIT_STD
    over the val images (fp32 forward on the card); written to `path`."""
    sd, meta = load_checkpoint(best)
    model = load_flax(model_from_meta(meta), sd["params"], sd["batch_stats"]).cuda().eval()
    ds_cfg = load_configs(None, None, data, make_run_dir=False)["dataset"]
    ds = YoloDataset(ds_cfg["val_images"], ds_cfg["val_labels"], img_size=IMG,
                     is_train=False, augment=False)
    images = torch.from_numpy(collate([ds.get(i) for i in range(len(ds))])["image"]).cuda()
    heads = [m for m in model.modules() if isinstance(m, DetectHead)]
    logits = {"obj": [], "cls": []}

    def keep(part):
        return lambda mod, args, out: logits[part].append(
            (out - mod.bias[None, :, None, None]).flatten())
    hooks = [getattr(h, part).register_forward_hook(keep(part)) for h in heads
             for part in logits]
    try:
        with torch.inference_mode():
            model(normalize_images(images.permute(0, 3, 1, 2)))
    finally:
        for h in hooks:
            h.remove()
    scale = {part: CLI_LOGIT_STD / float(torch.cat(v).std()) for part, v in logits.items()}
    with torch.no_grad():
        for h in heads:
            for part, k in scale.items():
                getattr(h, part).weight.mul_(k)
    params, stats = to_flax(model)
    save_checkpoint(path, params, stats, meta)
    log(f"cli evaluate: head kernels scaled by obj {scale['obj']:.3f}, cls "
        f"{scale['cls']:.3f} (logit std {CLI_LOGIT_STD} over the val images)")
    del model, images
    torch.cuda.empty_cache()
    return path


def _self_labelled(best: str, val_dir: str, root: str) -> str:
    """The val images under `root`/images, labelled (`root`/labels, YOLO
    txt) with the bf16 Predictor's CLI_LABELS_PER_IMAGE best detections at
    evaluate's conf and iou; returns the images folder."""
    pred = Predictor(best, device="cuda")
    for sub in ("images", "labels"):
        os.makedirs(os.path.join(root, sub))
    for name in sorted(os.listdir(val_dir)):
        src = os.path.join(val_dir, name)
        shutil.copyfile(src, os.path.join(root, "images", name))
        img = host_codecs.imread_bgr(src)
        h, w = img.shape[:2]
        r = pred.infer_image_profiled(img, conf=0.001, iou=0.65)
        boxes, scores = np.asarray(r["boxes"]), np.asarray(r["scores"])
        rows = []
        for i in np.argsort(-scores, kind="stable"):
            x1, y1, x2, y2 = np.clip(boxes[i], 0, [w, h, w, h])
            if min(x2 - x1, y2 - y1) >= 1 and len(rows) < CLI_LABELS_PER_IMAGE:
                rows.append(f"{int(r['classes'][i])} {(x1 + x2) / 2 / w:.6f} "
                            f"{(y1 + y2) / 2 / h:.6f} {(x2 - x1) / w:.6f} "
                            f"{(y2 - y1) / h:.6f}\n")
        with open(os.path.join(root, "labels", os.path.splitext(name)[0] + ".txt"), "w") as f:
            f.writelines(rows)
    del pred
    torch.cuda.empty_cache()
    return os.path.join(root, "images")


def _cli_evaluate(card: str, best: str, data: str, work: str, secs: dict,
                  launches: dict):
    """evaluate bf16 and --quantize int8 on the best checkpoint with
    sharpened heads (`_sharpened`), over the val images labelled with the
    bf16 Predictor's own best detections (`_self_labelled`), so that the
    COCO stats are far from 0 and move with int8's detections. The int8
    run's Predictor is kept, with the first input of each shape that its
    model was fed on its device (the b8 val batch, not the CPU copy that
    evaluate times); after the counted run, every distinct quantized conv
    call of those inputs is held against the plain versions
    (`check_int8_model`)."""
    best = _sharpened(best, data, os.path.join(work, "sharpened.ckpt"))
    images = _self_labelled(best, os.path.join(os.path.dirname(data), "valid", "images"),
                            os.path.join(work, "labelled"))
    kept = {}

    def keep_input(_mod, args):
        x = args[0]
        same_device = x.device.type == kept["pred"].device.type
        if same_device and tuple(x.shape) not in kept["inputs"]:
            kept["inputs"][tuple(x.shape)] = x.detach().clone()

    class KeptPredictor(Predictor):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            kept.update(pred=self, inputs={})
            self.model.register_forward_pre_hook(keep_input)

    out = {}
    cli_evaluate.Predictor = KeptPredictor
    try:
        for q in (None, "int8"):
            key = f"evaluate_{q or 'bf16'}"
            torch.cuda.synchronize()
            cuda_nms.LAUNCHES = 0
            cuda_int8.reset_launches()
            t0 = time.perf_counter()
            res = cli_evaluate.main(["--weights", best, "--test_folder", images]
                                    + (["--quantize", q] if q else []))
            torch.cuda.synchronize()
            secs[key], launches[key] = time.perf_counter() - t0, cuda_nms.LAUNCHES
            int8 = dict(cuda_int8.LAUNCHES)
            out[key] = {"coco": res["coco"], "ms_per_img": res["ms_per_img"],
                        "ms_per_img_cpu": res["ms_per_img_cpu"], "int8_launches": int8}
            log(f"cli evaluate{' --quantize int8' if q else ''}: AP {res['coco']['AP']:.4f} "
                f"AP50 {res['coco']['AP50']:.4f} AR {res['coco']['AR']:.4f} on {VAL_N} val "
                f"images labelled with the bf16 Predictor's {CLI_LABELS_PER_IMAGE} best "
                f"detections each, in {secs[key]:.1f} s; forward {res['ms_per_img']:.3f} "
                f"ms/img (b8 @{IMG}, CUDA events); nms_suppress {launches[key]} launches, "
                f"int8 kernels {int8} [{card}]")
            if not all(np.isfinite(v) for v in res["coco"].values()):
                raise AssertionError(f"cli evaluate {key}: non-finite stats {res['coco']}")
            if launches[key] != -(-VAL_N // 8):
                raise AssertionError(f"cli evaluate {key}: {launches[key]} nms_suppress "
                                     f"launches")
            if bool(q) != all(n > 0 for n in int8.values()) or (not q and any(int8.values())):
                raise AssertionError(f"cli evaluate {key}: int8 kernel launches {int8}")
    finally:
        cli_evaluate.Predictor = Predictor
    if out["evaluate_bf16"]["coco"]["AP50"] < CLI_MIN_AP50:
        raise AssertionError(f"cli evaluate: bf16 AP50 {out['evaluate_bf16']['coco']['AP50']} "
                             f"on its own detections, under {CLI_MIN_AP50}")
    gap = {k: abs(out["evaluate_int8"]["coco"][k] - out["evaluate_bf16"]["coco"][k])
           for k in CLI_INT8_STATS}
    out["int8_gap"] = gap
    log(f"cli evaluate: int8 against bf16, |stat gap| {json.dumps(gap)} (tolerance "
        f"{CLI_INT8_STAT_TOL}); bf16 {json.dumps(out['evaluate_bf16']['coco'])}, int8 "
        f"{json.dumps(out['evaluate_int8']['coco'])}")
    if max(gap.values()) > CLI_INT8_STAT_TOL:
        raise AssertionError(f"cli evaluate: int8 stats off bf16's by {gap}")
    rows = {}
    for x in kept["inputs"].values():
        rows.update(check_int8_model(kept["pred"], x, timing=False)[0])
    out["int8_distinct_calls"] = len(rows)
    log(f"cli evaluate --quantize int8: kernels equal their plain versions at {len(rows)} "
        f"distinct quantized conv calls of the inputs it fed its model "
        f"({[list(k) for k in kept['inputs']]}) [{card}]")
    if not rows:
        raise AssertionError("cli evaluate: no quantized conv call was checked")
    del kept
    torch.cuda.empty_cache()
    return out


def _cli_infer(card: str, best: str, val_dir: str, work: str, secs: dict, launches: dict):
    out_dir = os.path.join(work, "infer")
    torch.cuda.synchronize()
    cuda_nms.LAUNCHES = 0
    t0 = time.perf_counter()
    got = cli_infer.main(["--weights", best, "--img", val_dir, "--conf", str(CLI_CONF),
                          "--save_txt", "--save_json", "--out_dir", out_dir])
    torch.cuda.synchronize()
    secs["infer"], launches["infer"] = time.perf_counter() - t0, cuda_nms.LAUNCHES
    if launches["infer"] != VAL_N or len(got) != VAL_N:
        raise AssertionError(f"cli infer: {launches['infer']} launches, {len(got)} images")
    api = YoloLite(best, device="cuda")
    n = 0
    for path, r in got.items():
        want = api.predict(path, conf=CLI_CONF)[0]
        stem = os.path.splitext(os.path.basename(path))[0]
        with open(os.path.join(out_dir, f"{stem}.json")) as f:
            saved = json.load(f)
        same = all(np.array_equal(r[k], want[k]) and np.allclose(saved[k], want[k], rtol=0,
                                                                   atol=1e-4)
                   for k in ("boxes", "scores", "classes"))
        with open(os.path.join(out_dir, f"{stem}.txt")) as f:
            rows = f.read().splitlines()
        if not same or len(rows) != len(want["boxes"]):
            raise AssertionError(f"cli infer: {path} differs from YoloLite.predict")
        n += len(rows)
    log(f"cli infer: {VAL_N} images in {secs['infer']:.1f} s, {n} detections at conf "
        f"{CLI_CONF}, equal to YoloLite.predict's, YOLO-txt and JSON written; "
        f"{launches['infer']} nms_suppress launches [{card}]")
    return {"detections": n}


def _cli_export(card: str, best: str, frame_path: str, work: str, secs: dict,
                launches: dict):
    """"nms" and "decoded" `.pt2` (fp32) and a "decoded" ONNX, each run by
    infer_exported on one frame and held against the fp32 Predictor (TF32
    off): "nms" against its infer_image, "decoded" against its eager graph
    through the same host post-processing. Each way, >= EXPORT_BF16_MATCH of
    the detections have one of the same class with the box within
    EXPORT_FP32_RTOL (.pt2) or ONNX_TOL (ONNX) of the image size and the
    score within the same bound (the host NMS may keep the other of two
    near-equal boxes)."""
    frame = host_codecs.imread_bgr(frame_path)
    out = {}
    torch.backends.cudnn.allow_tf32 = False
    try:
        pred32 = Predictor(best, device="cuda", dtype=torch.float32)

        def eager(images_u8):
            with torch.inference_mode():
                x = torch.from_numpy(np.ascontiguousarray(images_u8)).cuda()
                return deploy_export.graph_outputs(pred32, pred32.forward(x), "decoded",
                                                   IMG, CLI_CONF, 0.65, 300)
        want_dec = deploy_infer_exported.infer_frame(eager, {"format": "decoded",
                                                             "img_size": IMG},
                                                     frame, CLI_CONF, 0.45, 300)
        want_nms = pred32.infer_image_profiled(frame, conf=CLI_CONF, iou=0.65, max_det=300)
        for name, argv, want, tol in (
                ("nms_pt2", ["--format", "nms", "--fp32"], want_nms, EXPORT_FP32_RTOL),
                ("decoded_pt2", ["--format", "decoded", "--fp32"], want_dec,
                 EXPORT_FP32_RTOL),
                ("decoded_onnx", ["--format", "decoded", "--runtime", "onnx"], want_dec,
                 ONNX_TOL)):
            t0 = time.perf_counter()
            path = cli_export.main(["--weights", best, "--out_dir",
                                    os.path.join(work, "export", name)] + argv)
            secs[f"export_{name}"] = time.perf_counter() - t0
            torch.cuda.synchronize()
            cuda_nms.LAUNCHES = 0
            t0 = time.perf_counter()
            got = cli_infer_exported.main(["--artifact", path, "--img", frame_path,
                                           "--conf", str(CLI_CONF)])
            torch.cuda.synchronize()
            secs[f"infer_exported_{name}"] = time.perf_counter() - t0
            launches[f"infer_exported_{name}"] = cuda_nms.LAUNCHES
            share, total = _match(_result_dets(got), _result_dets(want), tol * IMG, tol)
            back, _ = _match(_result_dets(want), _result_dets(got), tol * IMG, tol)
            share = min(share, back)
            ok = share >= EXPORT_BF16_MATCH and total > 0
            out[name] = {"matched": share, "detections": total,
                         "launches": launches[f"infer_exported_{name}"], "path": path}
            log(f"cli export {name}: {secs[f'export_{name}']:.1f} s; infer_exported "
                f"{len(got['boxes'])} detections, {100 * share:.2f}% of the Predictor's "
                f"matched, {out[name]['launches']} nms_suppress launches, "
                f"{secs[f'infer_exported_{name}']:.2f} s [{card}]")
            if not ok or out[name]["launches"] != (name == "nms_pt2"):
                raise AssertionError(f"cli export {name}: {out[name]}")
    finally:
        torch.backends.cudnn.allow_tf32 = True
    return out


def _cli_tracker(card: str, best: str, work: str, secs: dict, launches: dict):
    frames = make_clip(CLI_TRACK_FRAMES)
    seq = os.path.join(work, "frames")
    os.makedirs(seq)
    for i, f in enumerate(frames):
        write_png(os.path.join(seq, "%04d.png" % i), f[..., ::-1])
    torch.cuda.synchronize()
    cuda_nms.LAUNCHES = 0
    t0 = time.perf_counter()
    got = cli_tracker.main(["--weights", best, "--video", os.path.join(seq, "%04d.png"),
                            "--conf", str(CLI_CONF)])
    torch.cuda.synchronize()
    secs["tracker"], launches["tracker"] = time.perf_counter() - t0, cuda_nms.LAUNCHES
    pred = Predictor(best, device="cuda")
    tracker = KalmanSortTracker(iou_threshold=0.3, max_age=15, min_hits=2)
    want = [tracker.update(*pred.infer_image(f, conf=CLI_CONF, iou=0.45)) for f in frames]
    key = lambda per_frame: [[(t["track_id"], t["cls"], t["score"], t["bbox"].tolist())
                              for t in ts] for ts in per_frame]
    ids = {t["track_id"] for ts in got for t in ts}
    log(f"cli tracker: {len(got)} PNG frames (480x640) in {secs['tracker']:.1f} s, "
        f"{len(ids)} track ids, {launches['tracker']} nms_suppress launches (a frame and "
        f"the warmup) [{card}]")
    if launches["tracker"] != CLI_TRACK_FRAMES + 1 or len(got) != CLI_TRACK_FRAMES:
        raise AssertionError(f"cli tracker: {launches['tracker']} launches, {len(got)} frames")
    if key(got) != key(want) or not ids:
        raise AssertionError("cli tracker: tracks differ from KalmanSortTracker over "
                             "infer_image")
    return {"tracks": len(ids), "reported": sum(map(len, got))}


def phase_cli(card: str, data: str, tmp: str):
    """The port's command-line tools, each called in-process through its
    `main(argv)` on the card, edge_n at full width and depth @640 on the
    synthetic PNG set; runs go under a working directory of `tmp`. The
    backbone importer is host work with numpy and needs the JAX package and
    timm weights, which the card's machine lacks: it is held on the CPU only
    (tests/test_torch_port_backbone_import.py)."""
    work = os.path.join(tmp, "cli")
    os.makedirs(work)
    cwd = os.getcwd()
    os.chdir(work)
    secs, launches, out = {}, {}, {}
    try:
        best = _cli_train(card, data, work, secs, launches)
        out.update(_cli_evaluate(card, best, data, work, secs, launches))
        val_dir = os.path.join(os.path.dirname(data), "valid", "images")
        out["infer"] = _cli_infer(card, best, val_dir, work, secs, launches)
        out["export"] = _cli_export(card, best, os.path.join(val_dir, "0000.png"), work,
                                    secs, launches)
        out["tracker"] = _cli_tracker(card, best, work, secs, launches)
    finally:
        os.chdir(cwd)
    # for the draw phase: the sharpened checkpoint that evaluate wrote
    out["sharpened"] = os.path.join(work, "sharpened.ckpt")
    out["seconds"], out["launches"] = secs, launches
    log(f"cli: wall seconds {json.dumps({k: round(v, 2) for k, v in secs.items()})}; "
        f"nms_suppress launches {json.dumps(launches)} [{card}]")
    return out


# draw phase: every entry point that draws or writes images, and the
# offline weather tool, edge_n @640 with the cli phase's checkpoint and
# "nms" artifact; all drawing and encoding is host numpy
DRAW_DETS = 10                   # the drawing conf keeps about this many boxes a frame
DRAW_MAX_DET = 20                # predict's and infer's cap
DRAW_EPOCHS = 6                  # the val-debug images start at epoch 6
DRAW_TRAIN_N, DRAW_VAL_N = 8, 8  # the 6-epoch run's set
DRAW_PSNR_DB = 20.0              # floor of a JPEG file against its canvas (q95, 4:2:0)
DRAW_REENCODE_EVERY = 24         # JPEG files re-encoded for the byte check: 1 in this
DRAW_REPS = 5                    # host timings: median of this many
DRAW_TRACK_FRAMES = 60           # the tracker runs over this many frames of the clip
VIDEO_LUMA_PSNR_DB = 40.0        # floor of an mp4v file's luma against its canvas


@contextlib.contextmanager
def _captured_writes():
    """{absolute path: BGR canvas} of every image the port writes through
    `imwrite_bgr` while the block runs (the files are written too)."""
    from yololite_tpu_torch.data import imwrite as imwrite_mod
    from yololite_tpu_torch.data import weather as weather_mod
    from yololite_tpu_torch.utils import viz as viz_mod
    seen = {}
    write = imwrite_mod.imwrite_bgr

    def capture(path, img):
        seen[os.path.abspath(path)] = np.array(img, copy=True)
        write(path, img)
    mods = (imwrite_mod, viz_mod, weather_mod, cli_infer, cli_infer_exported, cli_tracker)
    for m in mods:
        m.imwrite_bgr = capture
    try:
        yield seen
    finally:
        for m in mods:
            m.imwrite_bgr = write


def _psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def _check_jpeg(data: bytes, canvas: np.ndarray, reencode: bool, what: str) -> float:
    """A JPEG of `canvas` (BGR): decoded by the port's codec within
    DRAW_PSNR_DB of it and, with `reencode`, byte for byte `encode_jpeg`'s."""
    got = host_codecs.decode_jpeg(data)
    psnr = _psnr(got, canvas)
    if got.shape != canvas.shape or psnr < DRAW_PSNR_DB:
        raise AssertionError(f"draw: {what} decodes {got.shape} at {psnr:.2f} dB of its "
                             f"canvas {canvas.shape} (floor {DRAW_PSNR_DB})")
    if reencode and data != encode_jpeg(canvas[..., ::-1]):
        raise AssertionError(f"draw: {what} is not the JPEG encoder's output of its canvas")
    return psnr


def _check_written(seen: dict, what: str) -> dict:
    """Every captured file exists and decodes (the port's codecs) to its
    canvas: PNG and BMP exactly, JPEG as `_check_jpeg` holds it."""
    psnrs = []
    for k, (path, canvas) in enumerate(sorted(seen.items())):
        if path.lower().endswith((".jpg", ".jpeg")):
            with open(path, "rb") as f:
                psnrs.append(_check_jpeg(f.read(), canvas, k % DRAW_REENCODE_EVERY == 0,
                                         path))
        elif not np.array_equal(host_codecs.imread_bgr(path), canvas):
            raise AssertionError(f"draw: {path} does not decode to its canvas")
    if not seen:
        raise AssertionError(f"draw: {what} wrote no image")
    return {"files": len(seen), "jpeg_min_psnr_db": min(psnrs) if psnrs else None}


def _median_ms(fn, reps: int = DRAW_REPS) -> float:
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return float(np.median(times) * 1e3)


def _draw_conf(pred, frames) -> float:
    """The score of each frame's DRAW_DETS-th best detection, median over
    `frames`: the operating point of the drawing runs (the sharpened scores
    saturate on the clip, so ties at it keep about that many a frame)."""
    kth = []
    for f in frames:
        scores = np.sort(np.asarray(pred.infer_image(f, conf=0.001, iou=0.45)[1]))[::-1]
        kth.append(float(scores[min(DRAW_DETS, len(scores)) - 1]) if len(scores) else 0.001)
    return max(float(np.median(kth)), 0.001)


def _counted(name: str, expected: int, launches: dict, secs: dict, fn):
    """Run `fn` with the kernel's launch count from 0; it must reach `expected`."""
    torch.cuda.synchronize()
    cuda_nms.LAUNCHES = 0
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    secs[name], launches[name] = time.perf_counter() - t0, cuda_nms.LAUNCHES
    if launches[name] != expected:
        raise AssertionError(f"draw {name}: nms_suppress launched {launches[name]} times, "
                             f"expected {expected}")
    return out


def _yolo_to_coco(img_dir: str, label_dir: str, path: str) -> str:
    """A COCO json of a YOLO-txt image folder (its images of one size)."""
    coco = {"images": [], "annotations": [],
            "categories": [{"id": i, "name": f"c{i}"} for i in range(3)]}
    names = sorted(os.listdir(img_dir))
    h, w = host_codecs.imread_bgr(os.path.join(img_dir, names[0])).shape[:2]
    for i, name in enumerate(names, 1):
        coco["images"].append({"id": i, "file_name": name, "width": w, "height": h})
        with open(os.path.join(label_dir, os.path.splitext(name)[0] + ".txt")) as f:
            for line in f.read().split("\n"):
                if line.strip():
                    c, cx, cy, bw, bh = (float(v) for v in line.split())
                    box = [(cx - bw / 2) * w, (cy - bh / 2) * h, bw * w, bh * h]
                    coco["annotations"].append({
                        "id": len(coco["annotations"]) + 1, "image_id": i,
                        "category_id": int(c), "bbox": box, "area": box[2] * box[3],
                        "iscrowd": 0})
    with open(path, "w") as f:
        json.dump(coco, f)
    return path


def _draw_timings(card: str, pred, frame: np.ndarray) -> dict:
    """Host ms of drawing a 640x480 frame's DRAW_DETS best detections and of
    encoding it, and of each weather effect, medians of DRAW_REPS."""
    boxes, scores, classes = (np.asarray(v)[:DRAW_DETS] for v in pred.infer_image(
        frame, conf=0.001, iou=0.45))
    rgb = np.ascontiguousarray(frame[..., ::-1])
    out = {"boxes": len(boxes),
           "draw_ms": _median_ms(lambda: draw_detections(rgb, boxes, scores, classes,
                                                         pred.names)),
           "jpeg_ms": _median_ms(lambda: encode_jpeg(rgb)),
           "png_ms": _median_ms(lambda: write_png(os.devnull, rgb)),
           "weather_ms": {e: _median_ms(lambda e=e: weather.apply_weather(
               frame, e, np.random.RandomState(0))) for e in weather.EFFECTS}}
    log(f"draw: host ms for a {frame.shape[1]}x{frame.shape[0]} frame: draw_detections "
        f"{out['draw_ms']:.2f} ({len(boxes)} boxes), JPEG q95 encode {out['jpeg_ms']:.2f}, "
        f"PNG encode {out['png_ms']:.2f}; weather effects "
        f"{json.dumps({k: round(v, 2) for k, v in out['weather_ms'].items()})} "
        f"[{_cpu_name()}; {card}]")
    return out


def _draw_predict(card: str, api, conf: float, folders: dict, frame, work: str,
                  launches: dict, secs: dict) -> dict:
    """YoloLite.predict(draw=True, save_dir=) on a PNG folder, a JPEG folder
    (one batched call each) and an array (pred_0.jpg); each plot is the
    file's canvas and the port's drawing of its detections."""
    out = {}
    for name, source in (*folders.items(), ("array", frame)):
        save = os.path.join(work, "predict", name)
        with _captured_writes() as seen:
            res = _counted(f"predict_{name}", 1, launches, secs,
                           lambda: api.predict(source, conf=conf, max_det=DRAW_MAX_DET,
                                               draw=True, save_dir=save))
        want = ([os.path.join(save, os.path.basename(r["source"])) for r in res]
                if name != "array" else [os.path.join(save, "pred_0.jpg")])
        if sorted(seen) != sorted(want):
            raise AssertionError(f"draw predict {name}: wrote {sorted(seen)}")
        for r, path in zip(res, want):
            src = (host_codecs.imread_bgr(r["source"]) if r["source"] else frame)[..., ::-1]
            drawn = draw_detections(src, r["boxes"], r["scores"], r["classes"],
                                    api.predictor.names)
            if not (np.array_equal(r["plot"], drawn) and np.array_equal(seen[path],
                                                                        drawn[..., ::-1])):
                raise AssertionError(f"draw predict {name}: {path} is not its drawing")
        out[name] = dict(_check_written(seen, f"predict {name}"),
                         boxes=[len(r["boxes"]) for r in res])
    if sum(sum(v["boxes"]) for v in out.values()) == 0:
        raise AssertionError("draw predict: no detection was drawn")
    log(f"draw predict: draw=True, save_dir= on {len(folders)} folders and an array in "
        f"{sum(secs[f'predict_{k}'] for k in out):.2f} s; boxes "
        f"{json.dumps({k: v['boxes'] for k, v in out.items()})}, files decode to their "
        f"canvases (JPEG >= {min(v['jpeg_min_psnr_db'] or 99 for v in out.values()):.2f} dB) "
        f"[{card}]")
    return out


def _draw_tools(card: str, ckpt: str, pt2: str, conf: float, val_dir: str, work: str,
                launches: dict, secs: dict) -> dict:
    """infer's `*_pred.jpg` and infer_exported --out (at CLI_CONF: the
    artifact is the unsharpened checkpoint's), each file the port's drawing
    of the tool's own detections."""
    out = {}
    infer_dir = os.path.join(work, "infer")
    with _captured_writes() as seen:
        got = _counted("infer", VAL_N, launches, secs, lambda: cli_infer.main(
            ["--weights", ckpt, "--img", val_dir, "--conf", str(conf), "--max_det",
             str(DRAW_MAX_DET), "--out_dir", infer_dir]))
    names = Predictor(ckpt, device="cuda").names
    for path, r in got.items():
        stem = os.path.splitext(os.path.basename(path))[0]
        drawn = draw_detections(host_codecs.imread_bgr(path)[..., ::-1], r["boxes"],
                                r["scores"], r["classes"], names)
        if not np.array_equal(seen[os.path.join(infer_dir, f"{stem}_pred.jpg")],
                              drawn[..., ::-1]):
            raise AssertionError(f"draw infer: {stem}_pred.jpg is not its drawing")
    out["infer"] = _check_written(seen, "infer")
    target = os.path.join(work, "exported.jpg")
    frame_path = os.path.join(val_dir, "0000.png")
    with _captured_writes() as seen:
        r = _counted("infer_exported", 1, launches, secs, lambda: cli_infer_exported.main(
            ["--artifact", pt2, "--img", frame_path, "--conf", str(CLI_CONF), "--out",
             target]))
    drawn = draw_detections(host_codecs.imread_bgr(frame_path)[..., ::-1], r["boxes"],
                            r["scores"], r["classes"], names)
    if not np.array_equal(seen[target], drawn[..., ::-1]) or not len(r["boxes"]):
        raise AssertionError(f"draw infer_exported: --out is not its drawing of "
                             f"{len(r['boxes'])} boxes")
    out["infer_exported"] = dict(_check_written(seen, "infer_exported"),
                                 boxes=len(r["boxes"]))
    log(f"draw infer: {VAL_N} *_pred.jpg in {secs['infer']:.2f} s; infer_exported --out "
        f"({len(r['boxes'])} boxes, the 'nms' .pt2) in {secs['infer_exported']:.2f} s; "
        f"{launches['infer']} + {launches['infer_exported']} nms_suppress launches [{card}]")
    return out


def _draw_tracker(card: str, ckpt: str, conf: float, frames, work: str, launches: dict,
                  secs: dict) -> dict:
    """tracker over the first DRAW_TRACK_FRAMES frames of the stream phase's
    clip (a BMP sequence): without --out, to an mp4v .avi and to a JPEG
    sequence; frames/s of each, every written frame its drawn canvas."""
    frames = frames[:DRAW_TRACK_FRAMES]
    seq = os.path.join(work, "seq")
    os.makedirs(seq)
    for i, f in enumerate(frames):
        write_bmp(os.path.join(seq, "%04d.bmp" % i), f[..., ::-1])
    base = ["--weights", ckpt, "--video", os.path.join(seq, "%04d.bmp"), "--conf", str(conf)]
    out, n = {}, len(frames)
    draw = cli_tracker.draw_tracks
    for name, extra in (("none", []), ("avi", ["--out", os.path.join(work, "track.avi")]),
                        ("pattern", ["--out", os.path.join(work, "track", "%04d.jpg")])):
        drawn = []

        def record(frame, tracks, fps):
            draw(frame, tracks, fps)
            drawn.append((frame.copy(), len(tracks)))
        cli_tracker.draw_tracks = record
        text = io.StringIO()
        try:
            with _captured_writes() as seen, contextlib.redirect_stdout(text):
                tracks = _counted(f"tracker_{name}", n + 1, launches, secs,
                                  lambda: cli_tracker.main(base + extra))
        finally:
            cli_tracker.draw_tracks = draw
        line = text.getvalue().strip().splitlines()[-1]
        tool_fps = float(line.split(" @ ")[1].split(" FPS")[0])
        out[name] = {"frames_per_s": n / secs[f"tracker_{name}"], "tool_fps": tool_fps,
                     "tracks": sum(map(len, tracks))}
        if len(tracks) != n or len(drawn) != (n if extra else 0):
            raise AssertionError(f"draw tracker {name}: {len(tracks)} frames, "
                                 f"{len(drawn)} drawn")
        if name == "avi":
            reader = host_video.VideoReader(extra[1])
            if (reader.codec, reader.frame_count, reader.fps) != \
                    ("mp4v", n, cli_tracker.SEQUENCE_FPS):
                raise AssertionError(f"draw tracker: {extra[1]} holds {reader.codec} "
                                     f"{reader.frame_count} frames at {reader.fps} fps")
            out[name]["luma_min_psnr_db"] = _luma_psnr_min(extra[1], [d[0] for d in drawn])
        elif name == "pattern":
            want = [os.path.join(work, "track", "%04d.jpg" % k) for k in range(1, n + 1)]
            if sorted(seen) != want or any(not np.array_equal(seen[p], d[0])
                                           for p, d in zip(want, drawn)):
                raise AssertionError("draw tracker: the sequence is not the drawn frames")
            out[name].update(_check_written(seen, "tracker pattern"))
        if extra and not any(k for _, k in drawn):
            raise AssertionError(f"draw tracker {name}: no track was drawn")
        log(f"draw tracker ({name if extra else 'no --out'}): {n} frames 480x640 in "
            f"{secs[f'tracker_{name}']:.2f} s, {out[name]['frames_per_s']:.1f} frames/s "
            f"(the tool's FPS {tool_fps:.1f}), {out[name]['tracks']} tracks reported, "
            f"{launches[f'tracker_{name}']} nms_suppress launches [{_cpu_name()}; {card}]")
    return out


def _draw_loop(card: str, work: str, launches: dict, secs: dict) -> dict:
    """A DRAW_EPOCHS-epoch run on a tiny set: sanity_check.jpg at the start,
    last_b0/1.jpg at the last epoch (val-debug starts at epoch 6)."""
    data = make_synth_set(os.path.join(work, "set"), DRAW_TRAIN_N, DRAW_VAL_N)
    calls = []
    debug = train_loop.save_val_debug

    def counted_debug(*a, **k):
        calls.append(k)
        debug(*a, **k)
    train_loop.save_val_debug = counted_debug
    val_batches = -(-DRAW_VAL_N // TRAIN_OVERRIDES["batch_size"])
    try:
        with _captured_writes() as seen:
            res = _counted("loop", (DRAW_EPOCHS + 1) * val_batches, launches, secs,
                           lambda: YoloLite("edge_n", device="cuda").train(
                               data=data, workers=8, run_dir=os.path.join(work, "runs"),
                               **dict(TRAIN_OVERRIDES, epochs=DRAW_EPOCHS,
                                      save_optimizer=False)))
    finally:
        train_loop.save_val_debug = debug
    log_dir = os.path.abspath(res["log_dir"])
    want = sorted(os.path.join(log_dir, f) for f in ("sanity_check.jpg", "last_b0.jpg",
                                                     "last_b1.jpg"))
    if sorted(seen) != want or len(calls) != 1:
        raise AssertionError(f"draw loop: wrote {sorted(seen)}, {len(calls)} val-debug calls")
    sanity = seen[want[2]]
    if sanity.shape != (2 * IMG, 4 * IMG, 3):
        raise AssertionError(f"draw loop: sanity canvas {sanity.shape}")
    out = dict(_check_written(seen, "loop"), train_s=secs["loop"],
               val_loss=res["history"]["val_loss"])
    log(f"draw loop: edge_n {DRAW_EPOCHS} epochs @{IMG} b8 on {DRAW_TRAIN_N} + "
        f"{DRAW_VAL_N} images in {secs['loop']:.1f} s: sanity_check.jpg "
        f"{sanity.shape[1]}x{sanity.shape[0]}, last_b0/1.jpg of epoch {DRAW_EPOCHS}; "
        f"{launches['loop']} nms_suppress launches [{card}]")
    return out


def _draw_weather(card: str, data: str, work: str, launches: dict, secs: dict) -> dict:
    """augment_weather over the training images in YOLO and COCO layout,
    then one epoch on the YOLO copy (its JPEGs read by the port's codec)."""
    root = os.path.dirname(data)
    images, labels = (os.path.join(root, "train", d) for d in ("images", "labels"))
    ann = _yolo_to_coco(images, labels, os.path.join(work, "train_coco.json"))
    out = {}
    for seed, (layout, extra) in enumerate((("yolo", ["--labels", labels]),
                                            ("coco", ["--coco_json", ann]))):
        dest = os.path.join(work, f"weather_{layout}")
        with _captured_writes() as seen, contextlib.redirect_stdout(io.StringIO()):
            n = _counted(f"weather_{layout}", 0, launches, secs, lambda: cli_augment.main(
                ["--images", images, "--out", dest, "--seed", str(seed)] + extra))
        names = sorted(os.listdir(os.path.join(dest, "images")))
        effects = [name.rsplit("_", 1)[1][:-5] for name in names]
        if n != TRAIN_N or len(names) != n:
            raise AssertionError(f"draw weather {layout}: {n} images, {len(names)} files")
        if layout == "yolo" and len(os.listdir(os.path.join(dest, "labels"))) != n:
            raise AssertionError("draw weather: labels were not copied")
        if layout == "coco":
            with open(os.path.join(dest, "annotations.json")) as f:
                coco = json.load(f)
            if len(coco["images"]) != 2 * TRAIN_N:
                raise AssertionError("draw weather: the COCO json lacks the new images")
        out[layout] = dict(_check_written(seen, f"weather {layout}"), seconds=secs[
            f"weather_{layout}"], effects={e: effects.count(e) for e in sorted(set(effects))})
        log(f"draw augment_weather ({layout}): {n} images in {secs[f'weather_{layout}']:.1f} s, "
            f"effects {json.dumps(out[layout]['effects'])} [{_cpu_name()}]")
    data_yaml = os.path.join(work, "weather.yaml")
    with open(data_yaml, "w") as f:
        f.write(f"train: {os.path.join(work, 'weather_yolo', 'images')}\n"
                f"val: {os.path.join(root, 'valid', 'images')}\nnc: 3\n"
                f"names: [c0, c1, c2]\n")
    val_batches = -(-VAL_N // TRAIN_OVERRIDES["batch_size"])
    res = _counted("weather_train", 2 * val_batches, launches, secs,
                   lambda: YoloLite("edge_n", device="cuda").train(
                       data=data_yaml, workers=8, run_dir=os.path.join(work, "runs_weather"),
                       **dict(TRAIN_OVERRIDES, epochs=1, save_optimizer=False)))
    hist = res["history"]
    if not np.isfinite(hist["step_loss"] + hist["val_loss"]).all():
        raise AssertionError(f"draw weather: non-finite loss {hist}")
    out["train"] = {"step_loss": hist["step_loss"], "val_loss": hist["val_loss"],
                    "seconds": secs["weather_train"]}
    log(f"draw weather train: 1 epoch @{IMG} b8 on the {TRAIN_N} weather JPEGs in "
        f"{secs['weather_train']:.1f} s, step losses "
        f"{', '.join(f'{v:.3f}' for v in hist['step_loss'])}; {launches['weather_train']} "
        f"nms_suppress launches [{card}]")
    return out


def phase_draw(card: str, data: str, tmp: str, cli: dict):
    """Drawing and the offline weather tool through the user entry points,
    edge_n @640 with the cli phase's sharpened checkpoint and "nms" .pt2:
    YoloLite.predict(draw=, save_dir=), infer, infer_exported --out, tracker
    --out (.avi and a sequence) over 60 frames of the clip, a 6-epoch run's
    sanity and val-debug images, and augment_weather (YOLO and COCO) with
    an epoch on its JPEGs. Every written file decodes with the port's codecs
    to the canvas drawn; nms_suppress launches as each step implies."""
    work = os.path.join(tmp, "draw")
    os.makedirs(work)
    ckpt, pt2 = cli["sharpened"], cli["export"]["nms_pt2"]["path"]
    launches, secs = {}, {}
    frames = make_clip(STREAM_FRAMES)
    pred = Predictor(ckpt, device="cuda")
    conf = _draw_conf(pred, frames[:8])
    log(f"draw: conf {conf:.4f} (the {DRAW_DETS}th best score, median over 8 frames)")
    out = {"conf": conf, "timings": _draw_timings(card, pred, frames[0])}
    val_dir = os.path.join(os.path.dirname(data), "valid", "images")
    jpg_dir = os.path.join(work, "val_jpg")
    os.makedirs(jpg_dir)
    for name in sorted(os.listdir(val_dir)):
        write_jpeg(os.path.join(jpg_dir, os.path.splitext(name)[0] + ".jpg"),
                   host_codecs.imread_bgr(os.path.join(val_dir, name))[..., ::-1], 90)
    cwd = os.getcwd()
    os.chdir(work)
    try:
        out["predict"] = _draw_predict(card, YoloLite(ckpt, device="cuda"), conf,
                                       {"png": val_dir, "jpg": jpg_dir}, frames[0], work,
                                       launches, secs)
        out.update(_draw_tools(card, ckpt, pt2, conf, val_dir, work, launches, secs))
        out["tracker"] = _draw_tracker(card, ckpt, conf, frames, work, launches, secs)
        out["loop"] = _draw_loop(card, work, launches, secs)
        out["weather"] = _draw_weather(card, data, work, launches, secs)
    finally:
        os.chdir(cwd)
    out["seconds"], out["launches"] = secs, launches
    log(f"draw: nms_suppress launches {json.dumps(launches)}, each as predicted; seconds "
        f"{json.dumps({k: round(v, 2) for k, v in secs.items()})} [{card}]")
    return out


# video phase: the committed clips, the writer's round trip and the tracker
# on a video file
VIDEO_FIXTURES = os.path.join(ROOT, "tests", "data", "video")
VIDEO_TIMING_640 = "mp4v_640x480.mp4"      # an I-VOP and 5 P-VOPs at 640x480
VIDEO_FPS = 30.0
H264_FIXTURES = os.path.join(VIDEO_FIXTURES, "h264")   # libx264's clips, cv2's manifest
H264_TIMED = ("d_high_640x480.mp4", "e_high_1920x1080.mp4")
H264_TRACKED = "d_high_640x480.mp4"         # 48 frames, High with B-frames, 25 fps
H264_FPS = 25.0
HEVC_FIXTURES = os.path.join(VIDEO_FIXTURES, "hevc")   # libx265's clips, cv2's manifest
HEVC_TIMED = ("l_640x480.mp4", "m_1920x1080.mp4", "n_main10_bt601_640x480.mp4")
HEVC_TRACKED = "l_640x480.mp4"             # 24 frames, x265's defaults (WPP, B-pyramid), 25 fps
# clips whose BGR frames differ from cv2's on purpose (ROADMAP, "Where the
# port deliberately differs"): their planes are held to the MD5 SEI alone
HEVC_CV2_DIFFERS = ("c_ctu16_slices_328x244.mov",)
# clips whose colours cv2 maps before BGR (BT.2020 HLG): the port refuses
# their frames naming this, and holds their planes to the MD5 SEI
HEVC_COLOUR_MANAGED = {"f_main10_hlg_640x480.mov": "ARIB STD-B67 (HLG)"}
# access units whose MD5 SEI x265 wrote for pictures its stream does not code
# (motion search at 64-wide pictures; tests/hevc_fixtures.py MD5_DIFFERS)
HEVC_MD5_DIFFERS = {"o_noise64_qp4.mp4": (1, 2, 3, 4), "o_noise64_qp20.mp4": (2, 3)}
VIDEO_FRAMES = 60                           # of make_clip's, written and tracked (cut for the time limit)
# the containers around the decoders (tests/container_fixtures.py): Matroska,
# MPEG-TS/M2TS, fragmented MP4, raw Annex B and OpenDML AVI, cv2's manifest
CONTAINER_FIXTURES = os.path.join(VIDEO_FIXTURES, "containers")
# (clip, --out or None, the fragmented .mp4 of the same stream its tracks must equal)
CONTAINER_TRACKED = (("a_h264.mkv", "tracker_mkv_out.mkv", "a_h264_frag.mp4"),
                     ("b_hevc.ts", None, "b_hevc_frag.mp4"))
CONTAINER_CONF = 0.01
CONTAINER_REPS = 3


def _luma_psnr_min(path: str, canvases) -> float:
    """The lowest PSNR of an mp4v file's decoded luma (the decoder's own
    plane) against the BT.601 luma of each canvas (BGR); the file must hold
    exactly these frames and none may fall below VIDEO_LUMA_PSNR_DB."""
    reader = host_video.VideoReader(path)
    dec = host_video.Mpeg4Decoder(reader.track.extradata)
    w, h = reader.size
    psnrs = []
    for pkt, canvas in zip(reader.packets(), canvases):
        y = dec.decode(pkt, planes=True)[:w * h].reshape(h, w).astype(np.int32)
        c = canvas[:h, :w].astype(np.int32)
        want = ((66 * c[..., 2] + 129 * c[..., 1] + 25 * c[..., 0] + 128) >> 8) + 16
        psnrs.append(_psnr(y, want))
    dec.close()
    if len(psnrs) != len(canvases) or min(psnrs) < VIDEO_LUMA_PSNR_DB:
        raise AssertionError(f"video: {path} holds {len(psnrs)} of {len(canvases)} frames, "
                             f"luma at {min(psnrs):.2f} dB (floor {VIDEO_LUMA_PSNR_DB})")
    return min(psnrs)


def _video_fixtures(card: str) -> dict:
    """Every committed clip decoded here, held to cv2's manifest."""
    with open(os.path.join(VIDEO_FIXTURES, "manifest.json")) as f:
        manifest = json.load(f)
    sha = lambda b: hashlib.sha256(bytes(b)).hexdigest()
    out = {}
    for name, want in sorted(manifest.items()):
        t0 = time.perf_counter()
        reader = host_video.VideoReader(os.path.join(VIDEO_FIXTURES, name))
        meta = [reader.fps, reader.frame_count, list(reader.size)]
        packets = [sha(p) for p in reader.packets()]
        frames = [sha(np.ascontiguousarray(f)) for f in reader]
        secs = time.perf_counter() - t0
        exact = len(frames) - len(reader.damaged)
        if (meta != [want["fps"], want["frame_count"], want["size"]]
                or packets != want["packets"] or len(frames) != len(want["frames"])
                or frames[:exact] != want["frames"][:exact]
                or reader.damaged not in ([], [len(frames) - 1])):
            raise AssertionError(f"video: {name} differs from cv2's manifest: {meta} vs "
                                 f"{[want['fps'], want['frame_count'], want['size']]}, "
                                 f"{len(frames)} frames, damaged {reader.damaged}")
        out[name] = {"frames": len(frames), "codec": reader.codec, "seconds": secs,
                     "concealed": reader.damaged, "stop": reader.stop_reason}
    try:
        host_video.VideoReader(os.path.join(VIDEO_FIXTURES, "vp80_64x48.webm"))
        raise AssertionError("video: the WebM clip did not raise")
    except host_video.UnsupportedVideo as e:
        out["vp80_64x48.webm"] = {"raised": str(e)[:60]}
    log(f"video fixtures: {len(manifest)} clips, every packet, fps, frame count, size and "
        f"frame SHA-256 equal to cv2's manifest (the truncated clip's last, concealed "
        f"frame by count); the WebM raises UnsupportedVideo [{_cpu_name()}]")
    return out


def _h264_fixtures(card: str) -> dict:
    """Every committed H.264 clip decoded on this host, held to cv2's
    manifest (packets, fps, frame count, size, every frame's SHA-256); each
    refused kind raises UnsupportedVideo naming its tool."""
    with open(os.path.join(H264_FIXTURES, "manifest.json")) as f:
        manifest = json.load(f)
    sha = lambda b: hashlib.sha256(bytes(b)).hexdigest()
    out = {}
    for name, want in sorted(manifest.items()):
        path = os.path.join(H264_FIXTURES, name)
        if "refused" in want:
            try:
                host_video.VideoReader(path)
            except host_video.UnsupportedVideo as e:
                if want["refused"] not in str(e):
                    raise AssertionError(f"video: {name} raised {e!r}, not naming "
                                         f"{want['refused']!r}")
                out[name] = {"refused": str(e).split(": ROADMAP")[0]}
                continue
            raise AssertionError(f"video: {name} ({want['refused']}) did not raise")
        t0 = time.perf_counter()
        reader = host_video.VideoReader(path)
        meta = [reader.fps, reader.frame_count, list(reader.size)]
        packets = [sha(p) for p in reader.packets()]
        frames = [sha(np.ascontiguousarray(f)) for f in reader]
        secs = time.perf_counter() - t0
        if (meta != [want["fps"], want["frame_count"], want["size"]]
                or packets != want["packets"] or frames != want["frames"]):
            bad = next((k for k, (a, b) in enumerate(zip(frames, want["frames"])) if a != b),
                       None)
            raise AssertionError(f"video: {name} differs from cv2's manifest: {meta} vs "
                                 f"{[want['fps'], want['frame_count'], want['size']]}, "
                                 f"packets equal {packets == want['packets']}, {len(frames)} "
                                 f"frames of {len(want['frames'])}, first differing {bad}")
        out[name] = {"frames": len(frames), "seconds": secs, "stop": reader.stop_reason}
    decoded = [n for n, r in out.items() if "frames" in r]
    log(f"video H.264 fixtures: {len(decoded)} clips ({sum(out[n]['frames'] for n in decoded)} "
        f"frames; Baseline/Main/High, CAVLC/CABAC, B-pyramid, weighted prediction, JVT "
        f"matrices, slices, full-range BT.709, AVI, avc3 open GOPs, QP 8 noise, an edit "
        f"list, a truncated file) every packet, fps, frame count, size and frame SHA-256 "
        f"equal to cv2's manifest; {len(out) - len(decoded)} refused kinds raise "
        f"UnsupportedVideo naming {sorted({r['refused'] for r in out.values() if 'refused' in r})} "
        f"[{_cpu_name()}]")
    return out


def _h264_timings(card: str) -> dict:
    """Host ms (1 thread) a picture to decode H.264 by picture type (the
    planes, no conversion) and to convert a frame to BGR, at 640x480 and
    1920x1080, median over DRAW_REPS passes of the clip."""
    out = {}
    for name in H264_TIMED:
        reader = host_video.VideoReader(os.path.join(H264_FIXTURES, name))
        samples = list(reader.samples())
        kinds, runs, conv = [], [], []
        for rep in range(DRAW_REPS):
            dec = host_video.H264Decoder(reader.track.extradata)
            times, got = [], []
            for k, sample in enumerate(samples):
                t0 = time.perf_counter()
                got += dec.decode(sample, k, planes=True)
                times.append(time.perf_counter() - t0)
                if rep == 0:
                    kinds.append("PBI"[dec.last_type])
            got += dec.flush(planes=True)
            dec.close()
            runs.append(times)
        w, h = reader.size
        lib = host_video.library()
        bgr = np.empty((h, w, 3), np.uint8)
        for planes, _ in got[:DRAW_REPS]:
            flat = np.concatenate([c.ravel() for c in planes])
            t0 = time.perf_counter()
            lib.yl_yuv_to_bgr(flat.ctypes.data, w, h, h // 2, 0, 2, bgr.ctypes.data)
            conv.append(time.perf_counter() - t0)
        ms = {k: float(np.median([r[i] for r in runs for i in range(len(kinds))
                                  if kinds[i] == k]) * 1e3) for k in sorted(set(kinds))}
        ms["to_bgr"] = float(np.median(conv) * 1e3)
        ms["frames_per_s"] = len(samples) / float(np.median([sum(r) for r in runs]))
        out[name] = {"size": [w, h], "kinds": "".join(kinds), "ms": ms}
        log(f"video H.264 host decode ms a {w}x{h} picture (1 thread): "
            + ", ".join(f"{k} {ms[k]:.2f}" for k in sorted(set(kinds)))
            + f"; to BGR {ms['to_bgr']:.2f}; {ms['frames_per_s']:.1f} pictures/s over the clip "
            f"({''.join(kinds)}, {name}) [{_cpu_name()}]")
    return out


def _h264_tracker(card: str, ckpt: str, conf: float, work: str, launches: dict,
                  secs: dict) -> dict:
    """tracker --device cuda --video <H.264 .mp4> --out out.mp4: a frame's
    nms_suppress launch each (and the warmup's), every frame written at the
    clip's rate; the tracks equal those on the frames as a PNG sequence."""
    clip = os.path.join(H264_FIXTURES, H264_TRACKED)
    frames = list(host_video.VideoReader(clip))
    n = len(frames)
    target = os.path.join(work, "tracker_h264_out.mp4")
    key = lambda per_frame: [[(t["track_id"], t["cls"], t["score"], t["bbox"].tolist())
                              for t in ts] for ts in per_frame]
    argv = ["--weights", ckpt, "--video", clip, "--conf", str(conf), "--device", "cuda",
            "--out", target]
    with contextlib.redirect_stdout(io.StringIO()):
        tracks = _counted("tracker_h264_out", n + 1, launches, secs,
                          lambda: cli_tracker.main(argv))
    seq = os.path.join(work, "seq_h264")
    os.makedirs(seq)
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(8) as pool:
        list(pool.map(lambda kf: write_png(os.path.join(seq, "%04d.png" % kf[0]),
                                           kf[1][..., ::-1]), enumerate(frames)))
    with contextlib.redirect_stdout(io.StringIO()):
        png = _counted("tracker_h264_png", n + 1, launches, secs, lambda: cli_tracker.main(
            ["--weights", ckpt, "--video", os.path.join(seq, "%04d.png"), "--conf", str(conf),
             "--device", "cuda"]))
    reader = host_video.VideoReader(target)
    if len(tracks) != n or (reader.frame_count, reader.fps) != (n, H264_FPS):
        raise AssertionError(f"video tracker_h264_out: {len(tracks)} frames of {n}, --out "
                             f"holds {reader.frame_count} frames at {reader.fps} fps")
    if key(tracks) != key(png) or not sum(map(len, tracks)):
        raise AssertionError("video: the tracks on the H.264 .mp4 differ from those on its "
                             "frames as a PNG sequence (or none were reported)")
    fps = n / secs["tracker_h264_out"]
    log(f"video tracker_h264_out: {n} frames {frames[0].shape[1]}x{frames[0].shape[0]} of "
        f"{H264_TRACKED} with --out out.mp4 in {secs['tracker_h264_out']:.2f} s, {fps:.1f} "
        f"frames/s, {sum(map(len, tracks))} tracks, {launches['tracker_h264_out']} "
        f"nms_suppress launches (a frame and the warmup; predicted {n + 1}), equal to the PNG "
        f"sequence's [{_cpu_name()}; {card}]")
    return {"frames_per_s": fps, "tracks": sum(map(len, tracks)),
            "png_frames_per_s": n / secs["tracker_h264_png"]}


def _hevc_picture_md5s(annexb: bytes) -> list:
    """The planes' MD5s of each decoded picture hash SEI (suffix SEI,
    payloadType 132, hash_type 0) in an Annex B access unit."""
    out = []
    for part in annexb.split(b"\x00\x00\x01")[1:]:
        if (part[0] >> 1) & 0x3F != 40:
            continue
        p, zeros = bytearray(), 0                  # without emulation prevention
        for b in part[2:]:
            if zeros >= 2 and b == 3:
                zeros = 0
                continue
            zeros = zeros + 1 if b == 0 else 0
            p.append(b)
        i = 0
        while i + 2 < len(p) and p[i] != 0x80:
            kind = size = 0
            while p[i] == 0xFF:
                kind, i = kind + 255, i + 1
            kind, i = kind + p[i], i + 1
            while p[i] == 0xFF:
                size, i = size + 255, i + 1
            size, i = size + p[i], i + 1
            if kind == 132 and p[i] == 0:
                out.append([bytes(p[i + 1 + 16 * c:i + 17 + 16 * c]) for c in range(3)])
            i += size
    return out


def _hevc_fixtures(card: str) -> dict:
    """Every committed HEVC clip decoded on this host, held to cv2's manifest
    (packets, fps, frame count, size, every frame's SHA-256 but for the
    clips of HEVC_CV2_DIFFERS; the frames of HEVC_COLOUR_MANAGED refused by
    name) and every decoded picture's planes to its MD5
    SEI; each refused format raises UnsupportedVideo naming it."""
    with open(os.path.join(HEVC_FIXTURES, "manifest.json")) as f:
        manifest = json.load(f)
    sha = lambda b: hashlib.sha256(bytes(b)).hexdigest()
    out, pictures = {}, 0
    for name, want in sorted(manifest.items()):
        path = os.path.join(HEVC_FIXTURES, name)
        if "refused" in want:
            try:
                host_video.VideoReader(path)
            except host_video.UnsupportedVideo as e:
                if want["refused"] not in str(e):
                    raise AssertionError(f"video: {name} raised {e!r}, not naming "
                                         f"{want['refused']!r}")
                out[name] = {"refused": str(e).split(": ROADMAP")[0]}
                continue
            raise AssertionError(f"video: {name} ({want['refused']}) did not raise")
        t0 = time.perf_counter()
        reader = host_video.VideoReader(path)
        meta = [reader.fps, reader.frame_count, list(reader.size)]
        annexb = list(reader.packets())
        if name in HEVC_COLOUR_MANAGED:
            try:
                next(iter(reader))
                raise AssertionError(f"video: {name} gave a frame cv2 converts colour-managed")
            except host_video.UnsupportedVideo as e:
                if HEVC_COLOUR_MANAGED[name] not in str(e):
                    raise AssertionError(f"video: {name} raised {e!r}") from e
            frames = want["frames"]
        else:
            frames = [sha(np.ascontiguousarray(f)) for f in reader]
        secs = time.perf_counter() - t0
        held = name not in HEVC_CV2_DIFFERS and name not in HEVC_COLOUR_MANAGED
        if (meta != [want["fps"], want["frame_count"], want["size"]]
                or [sha(p) for p in annexb] != want["packets"]
                or len(frames) != len(want["frames"]) or (held and frames != want["frames"])):
            raise AssertionError(f"video: {name} differs from cv2's manifest: {meta} vs "
                                 f"{[want['fps'], want['frame_count'], want['size']]}, "
                                 f"{len(frames)} frames of {len(want['frames'])}")
        dec = host_video.HevcDecoder(reader.track.extradata, uncropped=True)
        planes = []
        try:
            for k, sample in enumerate(reader.samples()):
                planes += dec.decode(sample, k, planes=True)
            planes += dec.flush(planes=True)
        except ValueError:              # the truncated clip's last sample
            if not reader.cut_short:
                raise
        finally:
            dec.close()
        for pl, k in planes:
            md5 = [hashlib.md5(np.ascontiguousarray(c).astype(c.dtype.newbyteorder("<")).tobytes())
                   .digest() for c in pl]
            miss = k in HEVC_MD5_DIFFERS.get(name, ())
            if ([md5] == _hevc_picture_md5s(annexb[k])[:1]) == miss:
                raise AssertionError(f"video: {name}: the picture of access unit {k} "
                                     f"{'equals' if miss else 'differs from'} its MD5 SEI")
        pictures += len(planes)
        out[name] = {"frames": len(frames), "pictures_md5": len(planes), "seconds": secs,
                     "frames_held_to_cv2": held, "stop": reader.stop_reason}
    decoded = [n for n, r in out.items() if "frames" in r]
    log(f"video HEVC fixtures: {len(decoded)} clips ({sum(out[n]['frames'] for n in decoded)} "
        f"frames; Main/Main 10/Main Still Picture, WPP, CTU 16 slices, transform skip, scaling "
        f"lists, AMP, weighted prediction, lossless and QP 4 noise, 64x64 noise, full-range "
        f"BT.709, Main 10 BT.601 and HLG in a .mov with dvvC, hev1 in-band, dvh1, AVI, an edit list, a truncated file) every "
        f"packet, fps, frame count and size equal to cv2's manifest, every frame's SHA-256 but "
        f"{list(HEVC_CV2_DIFFERS)}'s, {list(HEVC_COLOUR_MANAGED)}'s frames refused as cv2 "
        f"converts them colour-managed, and {pictures} pictures' planes held to their MD5 SEI: equal "
        f"but the {sum(map(len, HEVC_MD5_DIFFERS.values()))} x265 misses of HEVC_MD5_DIFFERS, "
        f"which differ; "
        f"{len(out) - len(decoded)} refused formats raise UnsupportedVideo naming "
        f"{sorted({r['refused'] for r in out.values() if 'refused' in r})} [{_cpu_name()}]")
    return out


def _hevc_timings(card: str) -> dict:
    """Host ms (1 thread) a picture to decode HEVC by picture type (cropped
    planes, no conversion) and to convert a frame to BGR, at 640x480 and
    1920x1080 (8-bit) and 640x480 Main 10, median over DRAW_REPS passes."""
    out = {}
    for name in HEVC_TIMED:
        reader = host_video.VideoReader(os.path.join(HEVC_FIXTURES, name))
        samples = list(reader.samples())
        kinds, runs, conv = [], [], []
        for rep in range(DRAW_REPS):
            dec = host_video.HevcDecoder(reader.track.extradata)
            times, got = [], []
            for k, sample in enumerate(samples):
                t0 = time.perf_counter()
                got += dec.decode(sample, k, planes=True)
                times.append(time.perf_counter() - t0)
                if rep == 0:
                    kinds.append("PBI"[dec.last_type])
            got += dec.flush(planes=True)
            dec.close()
            runs.append(times)
        w, h = reader.size
        depth = 10 if got[0][0][0].dtype == np.uint16 else 8
        for planes, _ in got[:DRAW_REPS]:
            flat = np.concatenate([c.ravel() for c in planes])
            t0 = time.perf_counter()
            host_video.to_bgr(flat, host_video.Picture(w, h, 0, 2, 0, depth=depth), "HEVC")
            conv.append(time.perf_counter() - t0)
        ms = {k: float(np.median([r[i] for r in runs for i in range(len(kinds))
                                  if kinds[i] == k]) * 1e3) for k in sorted(set(kinds))}
        ms["to_bgr"] = float(np.median(conv) * 1e3)
        ms["frames_per_s"] = len(samples) / float(np.median([sum(r) for r in runs]))
        out[name] = {"size": [w, h], "bits": depth, "kinds": "".join(kinds), "ms": ms}
        log(f"video HEVC host decode ms a {w}x{h} {depth}-bit picture (1 thread): "
            + ", ".join(f"{k} {ms[k]:.2f}" for k in sorted(set(kinds)))
            + f"; to BGR {ms['to_bgr']:.2f}; {ms['frames_per_s']:.1f} pictures/s over the clip "
            f"({''.join(kinds)}, {name}) [{_cpu_name()}]")
    return out


def _hevc_tracker(card: str, ckpt: str, conf: float, work: str, launches: dict,
                  secs: dict) -> dict:
    """tracker --device cuda --video <HEVC .mp4> --out out.mp4: a frame's
    nms_suppress launch each and the warmup's, every frame written at the
    clip's rate."""
    clip = os.path.join(HEVC_FIXTURES, HEVC_TRACKED)
    n = host_video.VideoReader(clip).frame_count
    target = os.path.join(work, "tracker_hevc_out.mp4")
    argv = ["--weights", ckpt, "--video", clip, "--conf", str(conf), "--device", "cuda",
            "--out", target]
    with contextlib.redirect_stdout(io.StringIO()):
        tracks = _counted("tracker_hevc_out", n + 1, launches, secs,
                          lambda: cli_tracker.main(argv))
    reader = host_video.VideoReader(target)
    if len(tracks) != n or (reader.frame_count, reader.fps) != (n, H264_FPS):
        raise AssertionError(f"video tracker_hevc_out: {len(tracks)} frames of {n}, --out "
                             f"holds {reader.frame_count} frames at {reader.fps} fps")
    fps = n / secs["tracker_hevc_out"]
    log(f"video tracker_hevc_out: {n} frames 640x480 of {HEVC_TRACKED} (HEVC) with --out "
        f"out.mp4 in {secs['tracker_hevc_out']:.2f} s, {fps:.1f} frames/s, "
        f"{sum(map(len, tracks))} tracks, {launches['tracker_hevc_out']} nms_suppress launches "
        f"(frames + 1 = {n + 1}) [{_cpu_name()}; {card}]")
    return {"frames_per_s": fps, "tracks": sum(map(len, tracks)), "launches":
            launches["tracker_hevc_out"]}


def _container_kind(name: str) -> str:
    ext = os.path.splitext(name)[1]
    if ext == ".mp4":
        return "fragmented mp4"
    if ext == ".avi":
        return "opendml avi"
    return {".h264": "annexb", ".hevc": "annexb"}.get(ext, ext[1:])


def _container_fixtures(card: str) -> dict:
    """Every committed container clip (Matroska, MPEG-TS/M2TS, fragmented
    MP4, raw Annex B, OpenDML AVI) read on this host and held to cv2's
    manifest: fps, frame count (the port's own where cv2's has no meaning,
    `port_frame_count`), size, every packet's and frame's SHA-256; and the
    host's demux ms a packet (parsing the container and reading its
    packets, no decoder; median of CONTAINER_REPS) for each kind of
    container."""
    with open(os.path.join(CONTAINER_FIXTURES, "manifest.json")) as f:
        manifest = json.load(f)
    sha = lambda b: hashlib.sha256(bytes(b)).hexdigest()
    out, demux = {}, {}
    for name, want in sorted(manifest.items()):
        path = os.path.join(CONTAINER_FIXTURES, name)
        reader = host_video.VideoReader(path)
        meta = [reader.fps, reader.frame_count, list(reader.size)]
        packets = [sha(p) for p in reader.packets()]
        frames = [sha(np.ascontiguousarray(f)) for f in reader]
        expect = [want["fps"], want.get("port_frame_count", want["frame_count"]), want["size"]]
        if meta != expect or packets != want["packets"] or frames != want["frames"]:
            raise AssertionError(f"video: {name} differs from cv2's manifest: {meta} vs {expect}, "
                                 f"{len(packets)} packets, {len(frames)} frames of "
                                 f"{len(want['frames'])}")
        def parse():                    # the container's parse and its packets, no decoder
            reader.track = host_video.probe(path)
            return list(reader.packets())
        ms = _median_ms(parse, CONTAINER_REPS) / len(packets)
        demux.setdefault(_container_kind(name), []).append(ms)
        out[name] = {"frames": len(frames), "codec": reader.codec, "demux_ms_a_packet": ms}
    out["demux_ms_a_packet"] = {k: float(np.median(v)) for k, v in sorted(demux.items())}
    log(f"video containers: {len(manifest)} clips, every packet, fps, frame count, size and frame "
        f"SHA-256 equal to cv2's manifest (raw Annex B and Matroska without Duration: the port's "
        f"frame count); host demux ms a packet (parse + packets, median of {CONTAINER_REPS}): "
        + ", ".join(f"{k} {v:.4f}" for k, v in out["demux_ms_a_packet"].items())
        + f" [{_cpu_name()}]")
    return out


def _container_checkpoint(work: str) -> str:
    """A seeded edge_n at 64 px (torch's default initialisation, seed 0, 3
    classes), which reports boxes on the 128x96 container clips at
    CONTAINER_CONF; the cli phase's sharpened 640 px model finds none there."""
    cfg = read_yaml(os.path.join(ROOT, "configs", "models", "edge_n.yaml"))
    cfg["model"] = dict(cfg["model"], num_classes=3)
    cfg["training"] = {"img_size": 64}
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = build_model_from_config(cfg).eval()
    return save_checkpoint(os.path.join(work, "edge_n_64.ckpt"), *to_flax(model),
                           build_meta(cfg, {}, "AP", ["c0", "c1", "c2"],
                                      model.get_num_anchors_per_level()))


def _container_trackers(card: str, work: str, launches: dict, secs: dict) -> dict:
    """tracker --device cuda on H.264 in .mkv with --out x.mkv, and on HEVC
    in .ts, each against the same tracker on the fragmented .mp4 of its
    stream: a frame's nms_suppress launch each and the warmup's, tracks
    reported and equal to the .mp4's; the .mkv written at the clip's rate,
    every frame."""
    ckpt = _container_checkpoint(work)
    key = lambda per_frame: [[(t["track_id"], t["cls"], t["score"], t["bbox"].tolist())
                              for t in ts] for ts in per_frame]
    out = {}
    for name, target, mp4 in CONTAINER_TRACKED:
        clip = os.path.join(CONTAINER_FIXTURES, name)
        src = host_video.VideoReader(clip)
        n = src.frame_count
        run = "tracker_" + name.replace(".", "_")
        argv = ["--weights", ckpt, "--conf", str(CONTAINER_CONF), "--min_hits", "1",
                "--device", "cuda"]
        with contextlib.redirect_stdout(io.StringIO()):
            tracks = _counted(run, n + 1, launches, secs, lambda: cli_tracker.main(
                argv + ["--video", clip] + (["--out", os.path.join(work, target)]
                                            if target else [])))
            same = _counted(run + "_mp4", n + 1, launches, secs, lambda: cli_tracker.main(
                argv + ["--video", os.path.join(CONTAINER_FIXTURES, mp4)]))
        if len(tracks) != n or key(tracks) != key(same) or not sum(map(len, tracks)):
            raise AssertionError(f"video {run}: {len(tracks)} frames of {n}, "
                                 f"{sum(map(len, tracks))} tracks, equal to {mp4}'s "
                                 f"{sum(map(len, same))}: {key(tracks) == key(same)}")
        if target:
            reader = host_video.VideoReader(os.path.join(work, target))
            if (reader.frame_count, reader.fps, len(list(reader))) != (n, src.fps, n):
                raise AssertionError(f"video {run}: --out holds {reader.frame_count} frames at "
                                     f"{reader.fps} fps")
        log(f"video {run}: {n} frames {src.size[0]}x{src.size[1]} of {name} ({src.codec})"
            f"{' with --out ' + target if target else ''} in {secs[run]:.2f} s, "
            f"{sum(map(len, tracks))} tracks (edge_n @64 seed 0, conf {CONTAINER_CONF}) equal "
            f"to those on {mp4}, {launches[run]} nms_suppress launches (frames + 1 = {n + 1}) "
            f"[{_cpu_name()}; {card}]")
        out[run] = {"frames": n, "tracks": sum(map(len, tracks)), "launches": launches[run],
                    "seconds": secs[run], "mp4_launches": launches[run + "_mp4"]}
    return out


def _video_timings(card: str, frame) -> dict:
    """Host ms (1 thread) to decode a 640x480 I-VOP, a P-VOP and a
    Motion-JPEG frame, median of DRAW_REPS."""
    reader = host_video.VideoReader(os.path.join(VIDEO_FIXTURES, VIDEO_TIMING_640))
    packets = list(reader.packets())
    kinds = ["IPBS"[p[p.find(b"\x00\x00\x01\xb6") + 4] >> 6] for p in packets]

    def decode_all():
        dec = host_video.Mpeg4Decoder(reader.track.extradata)
        times = []
        for p in packets:
            t0 = time.perf_counter()
            dec.decode(p)
            times.append(time.perf_counter() - t0)
        dec.close()
        return times
    runs = [decode_all() for _ in range(DRAW_REPS)]
    ms = {k: float(np.median([r[i] for r in runs for i in range(len(kinds)) if kinds[i] == k])
                   * 1e3) for k in set(kinds)}
    jpeg = encode_jpeg(frame[..., ::-1])
    ms["mjpeg"] = _median_ms(lambda: host_video.decode_mjpeg(jpeg))
    log(f"video host decode ms a 640x480 frame (1 thread): I-VOP {ms['I']:.2f}, P-VOP "
        f"{ms['P']:.2f} (mp4v from cv2's encoder, {''.join(kinds)}), Motion-JPEG "
        f"{ms['mjpeg']:.2f} ({frame.shape[1]}x{frame.shape[0]} q95 4:2:0, {len(jpeg)} bytes) "
        f"[{_cpu_name()}]")
    return ms


def _video_tracker(card: str, ckpt: str, conf: float, mp4: str, frames, work: str,
                   launches: dict, secs: dict) -> dict:
    """tracker --device cuda on the .mp4 and on its decoded frames written as
    a PNG sequence, each without and with --out out.mp4: equal tracks."""
    seq = os.path.join(work, "seq")
    os.makedirs(seq)
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(8) as pool:
        list(pool.map(lambda kf: write_png(os.path.join(seq, "%04d.png" % kf[0]),
                                           kf[1][..., ::-1]), enumerate(frames)))
    key = lambda per_frame: [[(t["track_id"], t["cls"], t["score"], t["bbox"].tolist())
                              for t in ts] for ts in per_frame]
    n, out, runs = len(frames), {}, {}
    for src, video in (("mp4", mp4), ("png", os.path.join(seq, "%04d.png"))):
        for written in (False, True):
            name = f"tracker_{src}" + ("_out" if written else "")
            target = os.path.join(work, f"{name}.mp4")
            argv = ["--weights", ckpt, "--video", video, "--conf", str(conf), "--device",
                    "cuda"] + (["--out", target] if written else [])
            with contextlib.redirect_stdout(io.StringIO()):
                tracks = _counted(name, n + 1, launches, secs, lambda: cli_tracker.main(argv))
            runs[name] = key(tracks)
            out[name] = {"frames_per_s": n / secs[name], "tracks": sum(map(len, tracks))}
            if len(tracks) != n:
                raise AssertionError(f"video {name}: {len(tracks)} frames of {n}")
            if written:
                reader = host_video.VideoReader(target)
                if (reader.frame_count, reader.fps) != (n, VIDEO_FPS if src == "mp4"
                                                        else cli_tracker.SEQUENCE_FPS):
                    raise AssertionError(f"video {name}: --out holds {reader.frame_count} "
                                         f"frames at {reader.fps} fps")
            log(f"video {name}: {n} frames {frames[0].shape[0]}x{frames[0].shape[1]} in "
                f"{secs[name]:.2f} s, "
                f"{out[name]['frames_per_s']:.1f} frames/s, {out[name]['tracks']} tracks, "
                f"{launches[name]} nms_suppress launches (a frame and the warmup) "
                f"[{_cpu_name()}; {card}]")
    if len({json.dumps(r) for r in runs.values()}) != 1 or not out["tracker_mp4"]["tracks"]:
        raise AssertionError("video: the tracks on the .mp4 differ from those on its frames "
                             "as a PNG sequence (or none were reported)")
    return out


def phase_video(card: str, tmp: str, cli: dict, draw: dict):
    """Video files on the card's host and the tracker on one, edge_n @640
    with the cli phase's sharpened checkpoint at the draw phase's conf: MP4,
    AVI, H.264 and HEVC, then the containers (Matroska, MPEG-TS/M2TS,
    fragmented MP4, raw Annex B, OpenDML AVI) and the tracker on a .mkv
    (with --out .mkv) and on a .ts."""
    t_phase = time.perf_counter()
    work = os.path.join(tmp, "video")
    os.makedirs(work)
    launches, secs = {}, {}
    out = {"fixtures": _video_fixtures(card), "h264_fixtures": _h264_fixtures(card)}
    frames = make_clip(VIDEO_FRAMES)
    out["decode_ms"] = _video_timings(card, frames[0])
    out["h264_decode_ms"] = _h264_timings(card)
    mp4 = os.path.join(work, "clip.mp4")
    t0 = time.perf_counter()
    with host_video.VideoWriter(mp4, VIDEO_FPS, (frames[0].shape[1], frames[0].shape[0])) as w:
        for f in frames:
            w.write(f)
    enc_ms = (time.perf_counter() - t0) * 1e3 / len(frames)
    reader = host_video.VideoReader(mp4)
    t0 = time.perf_counter()
    decoded = list(reader)
    dec_ms = (time.perf_counter() - t0) * 1e3 / len(frames)
    if (len(decoded), reader.frame_count, reader.fps) != (len(frames),) * 2 + (VIDEO_FPS,):
        raise AssertionError(f"video: the written .mp4 reads back as {len(decoded)} frames "
                             f"({reader.frame_count} in the index) at {reader.fps} fps")
    luma = _luma_psnr_min(mp4, frames)
    size_mb = os.path.getsize(mp4) / 1e6
    out["round_trip"] = {"encode_ms": enc_ms, "decode_ms": dec_ms, "mb": size_mb,
                         "luma_min_psnr_db": luma, "quant": host_video.WRITER_QUANT}
    log(f"video writer: {len(frames)} frames {frames[0].shape[0]}x{frames[0].shape[1]} as "
        f"mp4v I-VOPs (quantizer "
        f"{host_video.WRITER_QUANT}) in {enc_ms:.2f} ms a frame, {size_mb:.2f} MB; read back "
        f"{len(decoded)} frames at {reader.fps} fps in {dec_ms:.2f} ms a frame, luma >= "
        f"{luma:.2f} dB of each canvas [{_cpu_name()}]")
    out["tracker"] = _video_tracker(card, cli["sharpened"], draw["conf"], mp4, decoded, work,
                                    launches, secs)
    out["tracker_h264"] = _h264_tracker(card, cli["sharpened"], draw["conf"], work, launches,
                                        secs)
    t0 = time.perf_counter()
    out["hevc_fixtures"] = _hevc_fixtures(card)
    out["hevc_decode_ms"] = _hevc_timings(card)
    out["tracker_hevc"] = _hevc_tracker(card, cli["sharpened"], draw["conf"], work, launches,
                                        secs)
    out["hevc_seconds"] = time.perf_counter() - t0
    log(f"video HEVC part of the phase: {out['hevc_seconds']:.1f} s (fixtures, MD5s, timings, "
        f"tracker) [{_cpu_name()}; {card}]")
    t0 = time.perf_counter()
    out["container_fixtures"] = _container_fixtures(card)
    out["tracker_containers"] = _container_trackers(card, work, launches, secs)
    out["containers_seconds"] = time.perf_counter() - t0
    log(f"video containers part of the phase: {out['containers_seconds']:.1f} s (fixtures, demux "
        f"timings, .mkv and .ts trackers) [{_cpu_name()}; {card}]")
    out["seconds"], out["launches"] = secs, launches
    out["phase_seconds"] = time.perf_counter() - t_phase
    log(f"video phase: {out['phase_seconds']:.1f} s [{_cpu_name()}; {card}]")
    log(f"video: nms_suppress launches {json.dumps(launches)}, each as predicted [{card}]")
    return out


# tools phase: model_info over configs/models (12 configs), backbone
# pretraining on crops of the synthetic set (3 colour classes; ~2 steps an
# epoch at batch 32, so the EMA weights need ~20 epochs before their
# BatchNorm statistics catch up, as a CPU rehearsal showed), the benchmark
# harness, and the loop's profile flag
MODEL_INFO_CONFIGS = 12
PRETRAIN = dict(backbone="mobilenetv4_conv_small_050", epochs=25, batch_size=32,
                img_size=224, log_every=1)
BENCH_BATCH = 128


def _tools_model_info(card: str) -> dict:
    """`model_info --all` on the card, the table logged; parameters and
    FLOPs equal to the CPU's counts of the same configs."""
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rows = cli_model_info.main(["--all", "--img_size", str(IMG), "--device", "cuda"])
    secs = time.perf_counter() - t0
    for line in buf.getvalue().splitlines():
        log(f"model_info: {line}")
    if len(rows) != MODEL_INFO_CONFIGS or "FAILED" in buf.getvalue():
        raise AssertionError(f"model_info: {len(rows)} rows of {MODEL_INFO_CONFIGS}")
    with contextlib.redirect_stdout(io.StringIO()):
        cpu = cli_model_info.main(["--all", "--img_size", str(IMG), "--device", "cpu"])
    for a, b in zip(rows, cpu):
        if (a["params_M"], a["flops_G"]) != (b["params_M"], b["flops_G"]):
            raise AssertionError(f"model_info {a['model']}: card {a} != CPU {b}")
    log(f"model_info --all @{IMG}: {len(rows)} configs in {secs:.1f} s on the card, "
        f"params and FLOPs equal to the CPU's [{card}]")
    return {"seconds": secs, "rows": rows}


def _tools_pretrain(card: str, data: str, work: str) -> dict:
    """Crops of the synthetic set as an imagefolder, `pretrain_backbone` on
    the card: finite and falling loss, EMA val top-1 above the majority
    class's share."""
    crops = os.path.join(work, "crops")
    with contextlib.redirect_stdout(io.StringIO()):
        cli_make_crops.main(["--data", os.path.dirname(data), "--out", crops])
    counts = {split: {c: len(os.listdir(os.path.join(crops, split, c)))
                      for c in sorted(os.listdir(os.path.join(crops, split)))}
              for split in ("train", "val")}
    out = os.path.join(work, "mnv4_050_pre.ckpt")
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli_pretrain.pretrain(crops, out=out, device="cuda", **PRETRAIN)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    lines = buf.getvalue().splitlines()
    losses = [float(ln.split(" loss ")[1].split()[0]) for ln in lines if " loss " in ln]
    top1 = [float(ln.rsplit(" ", 1)[1]) for ln in lines if "val top-1" in ln]
    chance = max(counts["val"].values()) / sum(counts["val"].values())
    log(f"tools pretrain: {PRETRAIN['backbone']} {PRETRAIN['epochs']} epochs b"
        f"{PRETRAIN['batch_size']} @{PRETRAIN['img_size']} on {counts} crops in {secs:.1f} s "
        f"({len(losses)} steps); loss {losses[0]:.4f} -> {losses[-1]:.4f}; val top-1 by "
        f"epoch {top1} (majority share {chance:.4f}) [{card}]")
    k = max(1, len(losses) // 5)
    if not (np.all(np.isfinite(losses)) and np.mean(losses[-k:]) < np.mean(losses[:k])):
        raise AssertionError(f"pretrain: loss not finite and falling {losses}")
    if not top1[-1] > max(chance, 1 / 3):
        raise AssertionError(f"pretrain: val top-1 {top1[-1]} not above chance {chance}")
    return {"seconds": secs, "crops": counts, "losses": losses, "val_top1": top1,
            "checkpoint": out}


def _tools_pretrained_train(card: str, data: str, ckpt: str, work: str) -> dict:
    """The pretrained checkpoint in a 1-epoch edge_n run through
    `pretrained_backbone`: the backbone at step 0 equals it."""
    sd, _ = load_checkpoint(ckpt)
    seen = []
    real = Trainer.train_step

    def first(self, state, batch, lr_vec):
        if not seen:        # copies of the backbone's weights before the first step
            seen.append([[np.array(a) for a in _leaves(t["backbone"])]
                         for t in to_flax(state.model)])
        return real(self, state, batch, lr_vec)

    Trainer.train_step = first
    t0 = time.perf_counter()
    try:
        YoloLite("edge_n", device="cuda").train(
            data=data, epochs=1, batch_size=8, img_size=IMG, workers=8, augment=False,
            data_parallel=1, run_dir=os.path.join(work, "runs_pre"), pretrained_backbone=ckpt)
    finally:
        Trainer.train_step = real
    secs = time.perf_counter() - t0
    for got, want in zip(seen[0], (sd["params"], sd["batch_stats"])):
        want = _leaves(want)
        if len(got) != len(want) or not all(np.array_equal(a, b) for a, b in zip(got, want)):
            raise AssertionError("pretrained_backbone: the backbone at step 0 is not the "
                                 "checkpoint's")
    log(f"tools pretrained_backbone: 1 epoch of edge_n @{IMG} b8 from the pretrained "
        f"checkpoint in {secs:.1f} s; backbone at step 0 equal to it ({len(seen[0][0])} "
        f"+ {len(seen[0][1])} arrays) [{card}]")
    return {"seconds": secs}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [np.asarray(tree)]


@contextlib.contextmanager
def _one_process_training():
    """YoloLite.train with data_parallel 1 unless given (the benchmark tool,
    like JAX's, has no such flag)."""
    real = YoloLite.train

    def train(self, *a, **kw):
        kw.setdefault("data_parallel", 1)
        return real(self, *a, **kw)

    YoloLite.train = train
    try:
        yield
    finally:
        YoloLite.train = real


def _tools_benchmark(card: str, data: str, work: str, serve: dict) -> dict:
    """`benchmark --epochs 1 --batch_size 8 --bench_batch 128` on the card:
    a non-zero row; nms_suppress launched by validation, the latency calls
    and every graph call."""
    csv_path = os.path.join(work, "benchmark_results.csv")
    torch.cuda.synchronize()
    cuda_nms.LAUNCHES = 0
    t0 = time.perf_counter()
    with _one_process_training():
        rows = cli_benchmark.main(["--data", data, "--epochs", "1", "--batch_size", "8",
                                   "--img_size", str(IMG), "--bench_batch", str(BENCH_BATCH),
                                   "--out", csv_path, "--device", "cuda"])
    torch.cuda.synchronize()
    secs, launches = time.perf_counter() - t0, cuda_nms.LAUNCHES
    row = rows[0]
    if float(row[5]) == 0 or float(row[6]) == 0:
        raise AssertionError(f"benchmark wrote the zero row of a failed run: {row}")
    val_batches = -(-VAL_N // 8)
    want = (2 * val_batches + val_batches + 1 + cli_benchmark.LATENCY_CALLS
            + cli_benchmark.GRAPH_WARM + cli_benchmark.GRAPH_TIMED)
    log(f"tools benchmark: row {row} in {secs:.1f} s; batched graph {row[6]} img/s at "
        f"b{BENCH_BATCH} from a zero uint8 batch on the card (serve phase, prepared "
        f"batches: {[round(float(v), 1) for v in np.atleast_1d(serve['img_s_device_stream'])]} "
        f"img/s); latency {row[5]} ms a frame; nms_suppress launched {launches} times "
        f"(expected {want}: train {2 * val_batches}, val {val_batches}, warmup 1, "
        f"{cli_benchmark.LATENCY_CALLS} latency calls, "
        f"{cli_benchmark.GRAPH_WARM + cli_benchmark.GRAPH_TIMED} graph calls) [{card}]")
    if launches != want:
        raise AssertionError(f"benchmark: {launches} nms_suppress launches, expected {want}")
    return {"seconds": secs, "row": row, "launches": launches}


def _tools_profile(card: str, data: str, work: str) -> dict:
    """The loop's `profile` flag on a 2-epoch edge_n run: one trace of epoch
    1's batches 3 on (4 batches, so closed at the epoch's end) holding CUDA
    kernel events."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        res = YoloLite("edge_n", device="cuda").train(
            data=data, epochs=2, batch_size=8, img_size=IMG, workers=8, augment=False,
            data_parallel=1, run_dir=os.path.join(work, "runs_profile"), profile=True)
    secs = time.perf_counter() - t0
    prof = os.path.join(res["log_dir"], "profile")
    files = glob.glob(os.path.join(prof, "trace_*.json"))
    if buf.getvalue().count(f"[profile] trace saved to {prof}") != 1 or len(files) != 1:
        raise AssertionError(f"profile: {files} under {prof}")
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    busy = sum(float(e.get("dur", 0)) for e in kernels) / 1e3
    log(f"tools profile: 2 epochs of edge_n @{IMG} b8 in {secs:.1f} s; trace "
        f"{os.path.basename(files[0])} ({os.path.getsize(files[0]) / 1e6:.1f} MB) holds "
        f"{len(kernels)} CUDA kernel events, {busy:.1f} ms of kernels [{card}]")
    if not kernels:
        raise AssertionError("profile: the trace holds no CUDA kernel events")
    return {"seconds": secs, "kernel_events": len(kernels), "kernel_ms": busy}


def phase_tools(card: str, data: str, tmp: str, serve: dict):
    """The remaining user tools on the card, each through its entry point,
    edge_n at full width and depth @640 on the synthetic PNG set; runs go
    under a working directory of `tmp`."""
    work = os.path.join(tmp, "tools")
    os.makedirs(work)
    cwd = os.getcwd()
    os.chdir(work)
    out = {}
    try:
        out["model_info"] = _tools_model_info(card)
        out["pretrain"] = _tools_pretrain(card, data, work)
        out["pretrained_train"] = _tools_pretrained_train(card, data,
                                                          out["pretrain"]["checkpoint"], work)
        out["benchmark"] = _tools_benchmark(card, data, work, serve)
        out["profile"] = _tools_profile(card, data, work)
    finally:
        os.chdir(cwd)
    out["launches"] = out["benchmark"]["launches"]
    return out


# --------------------------------------------------------------------------- #
# synth: the four dataset generators on this machine's host (numpy; the
# card's machine has no cv2), then edge_n @640 trained by
# hardsynth_device_aug.yaml (2 epochs b8, validation every epoch) and
# evaluated on HardSynth-20, edge_n_seg 1 epoch on its polygon set, backbone
# pretraining on the classification corpus, and DIoU-NMS on the trained
# model's raw outputs, card against the plain version on the CPU
SYNTH_HS = ["--n_train", "32", "--n_val", "8", "--base", str(IMG), "--seed", "7"]
SYNTH_HS_SEG = ["--n_train", "16", "--n_val", "8", "--base", str(IMG), "--seed", "7", "--seg"]
SYNTH_SD = ["--n_train", "32", "--n_val", "8", "--img", "320"]
SYNTH_CLS = ["--per_class", "8", "--val_per_class", "2", "--img", "160"]
SYNTH_TRAIN = ["--epochs", "2", "--batch_size", "8", "--img_size", str(IMG), "--workers", "8",
               "--pretrained_backbone", BACKBONE_CKPT, "--data_parallel", "1"]
SYNTH_PRETRAIN = dict(PRETRAIN, epochs=2)
SYNTH_TOPK = (PRE_NMS_TOPK, 8400)          # the Predictor's top-k, and every anchor @640
SYNTH_IOU = (0.65, DIOU_NEG_THR)
# conf 0: every anchor with a score above 0 is a candidate (the 2-epoch model
# scores no anchor above the validation's 0.001 on HardSynth-20's 20 classes)
SYNTH_NMS = dict(conf_th=0.0, max_det=300, class_aware=True)


@contextlib.contextmanager
def _captured_generator_writes():
    """{absolute path: (BGR canvas, JPEG quality)} of every image the four
    generator tools write while the block runs (the files are written too)."""
    seen = {}
    jpeg, bgr = cli_make_hs.write_jpeg, cli_make_cls.imwrite_bgr

    def write_jpeg_(path, rgb, quality=90):
        seen[os.path.abspath(path)] = (np.array(rgb[..., ::-1]), quality)
        jpeg(path, rgb, quality)

    def imwrite_bgr_(path, img):
        seen[os.path.abspath(path)] = (np.array(img), JPEG_QUALITY)
        bgr(path, img)
    for m in (cli_make_hs, cli_make_synth):
        m.write_jpeg = write_jpeg_
    for m in (cli_make_cls, cli_make_crops):
        m.imwrite_bgr = imwrite_bgr_
    try:
        yield seen
    finally:
        for m in (cli_make_hs, cli_make_synth):
            m.write_jpeg = jpeg
        for m in (cli_make_cls, cli_make_crops):
            m.imwrite_bgr = bgr


def _check_generated(seen: dict, what: str) -> dict:
    """Every JPEG a generator wrote decodes with the port's codec within
    DRAW_PSNR_DB of the canvas it drew (1 in DRAW_REENCODE_EVERY byte for
    byte the encoder's output at its quality)."""
    psnrs = []
    for k, (path, (canvas, quality)) in enumerate(sorted(seen.items())):
        with open(path, "rb") as f:
            data = f.read()
        got = host_codecs.decode_jpeg(data)
        psnrs.append(_psnr(got, canvas))
        if got.shape != canvas.shape or psnrs[-1] < DRAW_PSNR_DB:
            raise AssertionError(f"synth: {path} decodes {got.shape} at {psnrs[-1]:.2f} dB of "
                                 f"its canvas {canvas.shape} (floor {DRAW_PSNR_DB})")
        if k % DRAW_REENCODE_EVERY == 0 and data != encode_jpeg(canvas[..., ::-1], quality):
            raise AssertionError(f"synth: {path} is not the encoder's output of its canvas")
    if not seen:
        raise AssertionError(f"synth: {what} wrote no image")
    return {"files": len(seen), "jpeg_min_psnr_db": min(psnrs)}


def _check_labels(root: str, nc: int, polygons: bool) -> dict:
    """Every label row of a generated YOLO set parses with the port's
    readers (boxes and polygons) with its class in [0, nc); a polygon set
    holds polygon rows."""
    rows = poly_rows = 0
    for split in ("train", "valid"):
        ldir = os.path.join(root, split, "labels")
        for fn in sorted(os.listdir(ldir)):
            path = os.path.join(ldir, fn)
            with open(path) as f:
                widths = [len(ln.split()) for ln in f.read().splitlines() if ln.strip()]
            n = len(widths)
            boxes, polys = parse_yolo_label_file(path), parse_yolo_seg_file(path)
            cls = boxes[:, 0]
            if len(boxes) != n or len(polys) != n or not (
                    (cls >= 0) & (cls < nc) & np.isfinite(boxes).all(1)).all():
                raise AssertionError(f"synth: {path}: {n} rows, parsed {len(boxes)} boxes "
                                     f"and {len(polys)} polygons, classes {cls.tolist()}")
            rows += n
            poly_rows += sum(w > 5 for w in widths)
    if polygons != (poly_rows > 0):
        raise AssertionError(f"synth: {root}: {poly_rows} polygon rows (polygons {polygons})")
    return {"rows": rows, "polygon_rows": poly_rows}


def _synth_generate(card: str, work: str) -> dict:
    """The four tools through main(argv): host ms a written image, every
    file and label row checked."""
    hs, hs_seg = os.path.join(work, "hardsynth"), os.path.join(work, "hardsynth_seg")
    runs = (("hardsynth", cli_make_hs, ["--out", hs] + SYNTH_HS, 20, False),
            ("hardsynth_seg", cli_make_hs, ["--out", hs_seg] + SYNTH_HS_SEG, 20, True),
            ("synth", cli_make_synth, ["--out", os.path.join(work, "synth")] + SYNTH_SD,
             4, False),
            ("synth_seg", cli_make_synth, ["--out", os.path.join(work, "synth_seg"),
                                           "--seg_polygons"] + SYNTH_SD, 4, True),
            ("crops", cli_make_crops, ["--data", hs, "--out", os.path.join(work, "crops")],
             None, None),
            ("cls", cli_make_cls, ["--out", os.path.join(work, "cls")] + SYNTH_CLS, None, None))
    out = {}
    for name, mod, argv, nc, polygons in runs:
        buf = io.StringIO()
        with _captured_generator_writes() as seen, contextlib.redirect_stdout(buf):
            t0 = time.perf_counter()
            mod.main(argv)
            secs = time.perf_counter() - t0
        files = _check_generated(seen, name)
        root = argv[argv.index("--out") + 1]
        labels = _check_labels(root, nc, polygons) if nc else None
        out[name] = dict(files, seconds=secs, ms_per_image=secs * 1e3 / files["files"],
                         labels=labels, root=root)
        log(f"synth {mod.__name__.rsplit('.', 1)[1]} {' '.join(argv[2:])}: {files['files']} "
            f"JPEGs in {secs:.2f} s, {out[name]['ms_per_image']:.2f} ms an image on the host "
            f"({_cpu_name()}); each decodes at >= {files['jpeg_min_psnr_db']:.2f} dB of its "
            f"canvas; {labels or 'no labels'}; "
            f"{' | '.join(buf.getvalue().strip().splitlines())[:240]} [{card}]")
    return out


def _synth_recipe(work: str) -> str:
    """hardsynth_device_aug.yaml with validation every epoch (the command
    line has no --eval_every)."""
    cfg = read_yaml(os.path.join(ROOT, "configs", "train", "hardsynth_device_aug.yaml"))
    cfg["training"]["eval_every"] = 1
    path = os.path.join(work, "hardsynth_device_aug_eval1.yaml")
    with open(path, "w") as f:
        f.write(dump_yaml(cfg))
    return path


def _synth_train(card: str, rel: str, data: str, recipe: str, epochs: int, what: str) -> dict:
    """`tools.train` on a generated set: finite losses, the launches
    (validation each epoch and the final evaluation) and, per step, the
    loss metrics the trainer returned."""
    steps = []
    real = Trainer.train_step

    def step(self, state, batch, lr_vec):
        state, metrics = real(self, state, batch, lr_vec)
        steps.append({k: float(v) for k, v in metrics.items()})
        return state, metrics
    argv = ["--model", os.path.join(ROOT, rel), "--train", recipe, "--data", data] + \
        SYNTH_TRAIN + ["--epochs", str(epochs)]
    Trainer.train_step = step
    torch.cuda.synchronize()
    cuda_nms.LAUNCHES = 0
    t0 = time.perf_counter()
    try:
        res = cli_train.main(argv)
    finally:
        Trainer.train_step = real
    torch.cuda.synchronize()
    secs, launches = time.perf_counter() - t0, cuda_nms.LAUNCHES
    hist = res["history"]
    expected = epochs + 1                       # 8 val images: one b8 batch a validation
    log(f"synth {what}: {epochs} epoch(s) of {os.path.basename(rel)} @{IMG} b8 "
        f"(hardsynth_device_aug.yaml, eval_every 1) in {secs:.1f} s, {len(steps)} steps; epoch "
        f"train loss {[round(float(v), 4) for v in hist['train_loss']]}, val loss "
        f"{[round(float(v), 4) for v in hist['val_loss']]}; final COCO AP50 "
        f"{res.get('coco', {}).get('AP50', float('nan')):.4f}; nms_suppress launched "
        f"{launches} times (expected {expected}) [{card}]")
    if launches != expected:
        raise AssertionError(f"synth {what}: {launches} nms_suppress launches, expected {expected}")
    if not all(np.isfinite(hist["step_loss"] + hist["val_loss"])) or not steps:
        raise AssertionError(f"synth {what}: non-finite loss {hist}")
    # 2 epochs on 20 hard classes: the final evaluation may draw no P/R/F1 curve
    _check_run_dir(res["log_dir"], curves=False)
    return {"seconds": secs, "launches": launches, "history": hist, "steps": steps,
            "coco": res.get("coco"), "coco_segm": res.get("coco_segm"),
            "best": os.path.join(res["log_dir"], "weights", "best_model_state.ckpt")}


def _synth_nms(card: str, best: str, data: str) -> dict:
    """The trained edge_n's raw outputs on the 8 val images (8,400 anchors):
    at each pre-NMS top-k, IoU and DIoU, each threshold, the kernel's keep
    mask equal to the plain version's on the same tensors on the CPU (the
    overlap matrix built once a metric), timed beside its bound; then
    `batched_nms` on the card, launches counted, its detections bit for bit
    the plain version's."""
    sd, meta = load_checkpoint(best)
    model = load_flax(model_from_meta(meta), sd["params"], sd["batch_stats"]).cuda().eval()
    ds_cfg = load_configs(None, None, data, make_run_dir=False)["dataset"]
    ds = YoloDataset(ds_cfg["val_images"], ds_cfg["val_labels"], img_size=IMG,
                     is_train=False, augment=False)
    images = torch.from_numpy(collate([ds.get(i) for i in range(len(ds))])["image"]).cuda()
    with torch.no_grad():
        boxes, scores, classes = _decode_scores(model(normalize_images(images.permute(0, 3, 1, 2))))
    del model
    host = [t.cpu() for t in (boxes, scores, classes)]
    rows, plain = {}, {}
    for k in SYNTH_TOPK:
        kk = min(k, boxes.shape[1])
        cand = select_candidates(boxes, scores, classes, k=kk, conf_th=SYNTH_NMS["conf_th"],
                                 class_aware=True)
        cand_h = select_candidates(*host, k=kk, conf_th=SYNTH_NMS["conf_th"], class_aware=True)
        if not all(torch.equal(a.cpu(), b) for a, b in zip(cand, cand_h)):
            raise AssertionError(f"synth nms: top-{kk} candidates differ card vs CPU")
        top_h, idx_h, boxes_h, cls_h, valid_h, shifted_h = cand_h
        valid, shifted = cand[4], cand[5].contiguous()
        if int(valid.sum()) < len(images):
            raise AssertionError(f"synth nms: {int(valid.sum())} candidates above conf "
                                 f"{SYNTH_NMS['conf_th']} in the top {kk}: nothing to suppress")
        for diou in (False, True):
            t0 = time.perf_counter()
            overlap = _suppression_matrix(shifted_h, diou)
            matrix_s = time.perf_counter() - t0
            for thr in SYNTH_IOU:
                key = f"{'diou' if diou else 'iou'}_k{kk}_thr{thr}"
                keep = cuda_nms.greedy_keep(shifted, valid, thr, diou)
                keep_h = _greedy_keep(overlap, valid_h, thr)
                if not torch.equal(keep.cpu(), keep_h):
                    raise AssertionError(f"synth nms {key}: {int((keep.cpu() != keep_h).sum())} "
                                         f"keep bits differ card vs CPU")
                ms = cuda_ms(lambda: cuda_nms.greedy_keep(shifted, valid, thr, diou), 20)
                bound, by, pairs = nms_bound_ms(
                    keep, valid, DIOU_FLOPS_PER_PAIR if diou else IOU_FLOPS_PER_PAIR)
                plain[key] = finalize_detections(keep_h, top_h, idx_h, boxes_h, cls_h,
                                                 max_det=SYNTH_NMS["max_det"])
                rows[key] = {"k": kk, "diou": diou, "iou_th": thr, "valid": int(valid.sum()),
                             "kept": int(keep.sum()), "ms": ms, "bound_ms": bound,
                             "bound_by": by, "pairs": pairs, "plain_matrix_s": matrix_s}
                log(f"synth nms {key}: B={len(images)} k={kk}, {int(valid.sum())} valid, "
                    f"{int(keep.sum())} kept, keep masks equal card vs CPU; kernel {ms:.4f} ms, "
                    f"bound {bound:.4f} ms ({by}, {pairs} pairs) [{card}]")
            del overlap
    # the main path: batched_nms on the card (IoU and DIoU), launches counted
    torch.cuda.synchronize()
    cuda_nms.LAUNCHES = cuda_nms.LAUNCHES_DIOU = 0
    for key, r in rows.items():
        got = batched_nms(boxes, scores, classes, iou_th=r["iou_th"], pre_nms_topk=r["k"],
                          use_diou=r["diou"], **SYNTH_NMS)
        for name, g, w in zip(("boxes", "scores", "classes", "valid", "idx"), got, plain[key]):
            if not (g.device == boxes.device and torch.equal(g.cpu(), w)):
                raise AssertionError(f"synth nms {key}: batched_nms {name} card != CPU")
        r["detections"] = int(got[3].sum())
    torch.cuda.synchronize()
    launches, launches_diou = cuda_nms.LAUNCHES, cuda_nms.LAUNCHES_DIOU
    log(f"synth nms: batched_nms on the card equal to the plain version bit for bit in all "
        f"{len(rows)} cases (detections {[r['detections'] for r in rows.values()]}); "
        f"nms_suppress launched {launches} times, {launches_diou} of them DIoU (expected "
        f"{len(rows)}, {len(rows) // 2}) [{card}]")
    if (launches, launches_diou) != (len(rows), len(rows) // 2):
        raise AssertionError(f"synth nms: launches {launches}, DIoU {launches_diou}")
    return {"rows": rows, "launches": launches, "launches_diou": launches_diou}


def phase_synth(card: str, tmp: str):
    """The dataset generators and what is trained on their sets, on the card;
    runs go under a working directory of `tmp`."""
    work = os.path.join(tmp, "synth_tools")
    os.makedirs(work)
    cwd = os.getcwd()
    os.chdir(work)
    try:
        gen = _synth_generate(card, work)
        recipe = _synth_recipe(work)
        hs_data = os.path.join(gen["hardsynth"]["root"], "data.yaml")
        train = _synth_train(card, "configs/models/edge_n.yaml", hs_data, recipe, 2,
                             "train edge_n")
        loss = train["history"]["train_loss"]
        if not loss[-1] < loss[0]:
            raise AssertionError(f"synth train: epoch train loss not falling {loss}")
        torch.cuda.synchronize()
        cuda_nms.LAUNCHES = 0
        t0 = time.perf_counter()
        ev = cli_evaluate.main(["--weights", train["best"], "--test_folder",
                                os.path.join(gen["hardsynth"]["root"], "valid", "images")])
        torch.cuda.synchronize()
        ev_s, ev_launches = time.perf_counter() - t0, cuda_nms.LAUNCHES
        log(f"synth evaluate: best checkpoint on the 8 HardSynth val images in {ev_s:.1f} s: "
            f"{json.dumps({k: round(v, 4) for k, v in ev['coco'].items()})}; nms_suppress "
            f"launched {ev_launches} times (expected 1) [{card}]")
        if not all(np.isfinite(v) for v in ev["coco"].values()) or ev_launches != 1:
            raise AssertionError(f"synth evaluate: stats {ev['coco']}, launches {ev_launches}")
        seg = _synth_train(card, "configs/models/edge_n_seg.yaml",
                           os.path.join(gen["hardsynth_seg"]["root"], "data.yaml"), recipe, 1,
                           "train edge_n_seg")
        mask = [st["mask"] for st in seg["steps"]]
        log(f"synth train edge_n_seg: mask loss by step {[round(v, 4) for v in mask]}")
        if not (mask and np.all(np.isfinite(mask))):
            raise AssertionError(f"synth seg: mask loss {mask}")
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            cli_pretrain.pretrain(gen["cls"]["root"], out=os.path.join(work, "cls20.ckpt"),
                                  device="cuda", **SYNTH_PRETRAIN)
        torch.cuda.synchronize()
        pre_s = time.perf_counter() - t0
        losses = [float(ln.split(" loss ")[1].split()[0]) for ln in buf.getvalue().splitlines()
                  if " loss " in ln]
        log(f"synth pretrain_backbone: {SYNTH_PRETRAIN['backbone']} {SYNTH_PRETRAIN['epochs']} "
            f"epochs b{SYNTH_PRETRAIN['batch_size']} @{SYNTH_PRETRAIN['img_size']} on the "
            f"20-class corpus in {pre_s:.1f} s; loss by step {[round(v, 4) for v in losses]} "
            f"[{card}]")
        if not (losses and np.all(np.isfinite(losses))):
            raise AssertionError(f"synth pretrain: loss {losses}")
        nms = _synth_nms(card, train["best"], hs_data)
    finally:
        os.chdir(cwd)
    launches = train["launches"] + ev_launches + seg["launches"] + nms["launches"]
    log(f"synth: nms_suppress launches train {train['launches']} + evaluate {ev_launches} + "
        f"seg {seg['launches']} + batched_nms {nms['launches']} = {launches} "
        f"({nms['launches_diou']} DIoU) [{card}]")
    return {"generate": gen, "train": {k: v for k, v in train.items() if k != "steps"},
            "evaluate": {"coco": ev["coco"], "seconds": ev_s, "launches": ev_launches},
            "seg": {k: v for k, v in seg.items() if k != "steps"}, "seg_mask_loss": mask,
            "pretrain": {"seconds": pre_s, "losses": losses}, "nms": nms,
            "launches": launches, "launches_diou": nms["launches_diou"]}


# --------------------------------------------------------------------------- #
# ddp: data-parallel training, two ranks on this card over gloo (NCCL refuses
# two ranks on one device), each a process spawned here
DDP_WORLD = 2
DDP_BATCH = 16                   # the step check's global batch (8 a rank)
DDP_STEPS = 3                    # steps before the ranks' state checksums
DDP_TIME_STEPS = 10
DDP_TIMEOUT_S = 420
DDP_TRAIN = dict(TRAIN_OVERRIDES, save_optimizer=False, num_workers=8)
# 2 ranks vs one process, the same global batch and weights. fp32 (TF32
# off): the CPU test's tolerances (tests/test_torch_port_ddp.py: the loss
# 1e-5, metrics 3e-5, gradients 5e-4 relative L2, BN statistics 1e-4 abs;
# measured there 1.8e-6, 9.8e-6, 9.0e-5, 1.5e-5); on the card the
# gradients read 2.7e-4 at 640, where cuDNN picks its own algorithms for b8
# and b16. bf16 autocast: one process's plain step runs the bf16 batch_norm
# kernel where a rank normalizes in fp32 from the all-reduced sums, and the
# two part by 0.28 in the gradients. So the ranks' bf16 step is held against
# one process's bf16 step on the ranks' BatchNorm path at world 1
# (`_world_one_global_batchnorm`), where only the reduction (and cuDNN's
# b8 against b16 algorithms) differs. That reads loss 1.15e-4, metrics
# 1.22e-3, gradients 0.129 rel L2, BN 1.46e-3 (PR 14's chip run 5, PERF.md):
# a bf16 train-mode step of these seeded weights amplifies rounding as the
# fp32 one does (2.7e-4 from ~1e-7), to tenths at bf16's 2^-9, so DDP_BF16
# sits a few times above those readings (1.55x for the gradients, which
# reproduce to 3 digits run to run). What the bf16 gradients cannot show at
# that level is held exactly: each rank's reduced gradient is the sum of
# the two ranks' local ones, bit for bit (fp32 buckets in both precisions);
# the BatchNorm sums are all-reduced in fp32 in both, by the code the fp32
# check holds to 5e-4. One process's step on the batch with its halves
# swapped (the same sums in another order) prints bf16's own floor.
DDP_FP32 = {"loss": 1e-5, "metrics": 3e-5, "grads": 5e-4, "bn": 1e-4}
DDP_BF16 = {"loss": 5e-4, "metrics": 5e-3, "grads": 0.2, "bn": 5e-3}
DDP_EVAL_TOL = 1e-12             # the run's final COCO stats vs one process's


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().float().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def _ddp_step_run(cfg, params, stats, batch, dp, device: str, timed: bool,
                  steps: int = DDP_STEPS, time_steps: int = DDP_TIME_STEPS, dtype=None):
    """One Trainer step of the config's model from (params, stats) on
    `batch` (this rank's rows of it with `dp`): metrics, the gradients
    handed to the optimizer (and the local ones before the reduction),
    BatchNorm running statistics, the collectives it called, the step's peak
    device bytes; after `steps` steps the state's digests; with `timed`, ms a
    step by CUDA events over `time_steps` more. `dtype`: the model's (fp32
    by default); gradients and statistics are kept in at least fp32."""
    model = build_model_from_config(cfg)
    trainer = Trainer(model if dtype is None else model.to(dtype), cfg, total_updates=100,
                      device=device, parallel=dp)
    state = trainer.state_from_weights(params, stats)
    wide = lambda ts: torch.cat([t.reshape(-1).to(torch.promote_types(t.dtype, torch.float32))
                                 for t in ts]).cpu().numpy()
    seen = []
    real = trainer._apply_grads

    def keep(st, grads, lr_vec):
        if not seen:
            seen.append(wide(grads))
        return real(st, grads, lr_vec)

    trainer._apply_grads = keep
    local = []
    reduce_grads = trainer._reduce_grads

    def keep_local(grads):
        if not local:
            local.append(wide(grads))
        return reduce_grads(grads)

    trainer._reduce_grads = keep_local
    rows = batch if dp is None else {k: v[dp.batch_rows(len(v))] for k, v in batch.items()}
    b = trainer.put_batch(rows)
    lr = trainer.lr_vector(1e-3)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    pdist.reset_calls()
    state, m = trainer.train_step(state, b, lr)
    torch.cuda.synchronize()
    out = {"metrics": {k: float(v) for k, v in m.items()}, "grads": seen[0],
           "local_grads": local[0] if dp is not None else None, "calls": dict(pdist.CALLS),
           "peak_bytes": torch.cuda.max_memory_allocated(device),
           "bn": wide(v for k, v in state.model.state_dict().items() if "running" in k)}
    for _ in range(steps - 1):
        trainer.train_step(state, b, lr)
    opt = state.opt
    out["digest"] = {"model": _digest(state.model.state_dict().values()),
                     "ema": _digest(state.ema.state_dict().values()),
                     "opt": _digest([t for ts in (opt.mu, opt.nu, opt.trace) if ts is not None
                                     for t in ts]),
                     "counters": [state.updates, state.micro, opt.count]}
    if timed:
        s, e = _events(2)
        torch.cuda.synchronize()
        s.record()
        for _ in range(time_steps):
            trainer.train_step(state, b, lr)
        e.record()
        e.synchronize()
        out["step_ms"] = s.elapsed_time(e) / time_steps
    return out


@contextlib.contextmanager
def _world_one_global_batchnorm():
    """BatchNorm's data-parallel train forward (`_global_forward`: fp32
    statistics from the sums, normalized in fp32) in one process, where the
    sums' all-reduce is the identity: a world-1 step that differs from the
    ranks' only by the reduction."""
    forward = BatchNorm.forward

    def global_forward(self, x):
        return self._global_forward(x, 1, lambda t: t) if self.training else forward(self, x)

    BatchNorm.forward = global_forward
    try:
        yield
    finally:
        BatchNorm.forward = forward


def _ddp_collective_ms(dp, grads: np.ndarray, device: str) -> dict:
    """Device ms of the step's collectives alone, by CUDA events over 10
    calls each: the gradient bucket's all-reduce and one BatchNorm's (2C
    floats, C=96)."""
    out = {}
    for name, n in (("grad_bucket", grads.size), ("batchnorm_96", 192)):
        t = torch.ones(n, device=device)
        pdist.all_reduce_(t)
        torch.cuda.synchronize()
        s, e = _events(2)
        s.record()
        for _ in range(10):
            pdist.all_reduce_(t)
        e.record()
        e.synchronize()
        out[name] = s.elapsed_time(e) / 10
    return out


def _ddp_rank(rank: int, port: int, backend: str, devices, job) -> dict:
    """One rank of the ddp phase: the step checks, then train_from_config
    joined to this group."""
    os.environ["LOCAL_RANK"], os.environ["LOCAL_WORLD_SIZE"] = str(rank), str(DDP_WORLD)
    device = devices[rank]
    torch.cuda.set_device(device)
    pdist.init_distributed(f"localhost:{port}", DDP_WORLD, rank, backend=backend)
    try:
        dp = pdist.DataParallel.from_group()
        res = {"backend": backend}
        for name, amp in (("fp32", False), ("bf16", True)):
            torch.backends.cudnn.allow_tf32 = amp
            torch.backends.cuda.matmul.allow_tf32 = amp
            res[name] = _ddp_step_run(job["cfgs"][name], *job["weights"], job["batch"], dp,
                                      device, timed=amp)
        torch.backends.cudnn.allow_tf32 = True
        res["collective_ms"] = _ddp_collective_ms(dp, res["bf16"]["grads"], device)
        cuda_nms.LAUNCHES = 0
        pdist.reset_calls()
        t0 = time.perf_counter()
        train = train_loop.train_from_config(job["train_cfgs"][rank], device=device)
        torch.cuda.synchronize()
        res["train"] = {"launches": cuda_nms.LAUNCHES, "seconds": time.perf_counter() - t0,
                        "coco": train.get("coco"), "history": train.get("history"),
                        "log_dir": train.get("log_dir"), "calls": dict(pdist.CALLS)}
    finally:
        pdist.shutdown()
    return res


def _ddp_spawn(backend: str, devices, job):
    return pdist.spawn(_ddp_rank, (pdist.free_port(), backend, devices, job), DDP_WORLD,
                       timeout=DDP_TIMEOUT_S)


def _grad_rel(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.linalg.norm(got.astype(np.float64) - want) / np.linalg.norm(want))


def _halves_swapped(batch: dict) -> dict:
    """The batch with its second half first (every loss term and batch
    statistic is a sum over images: the same step in another order)."""
    h = DDP_BATCH // 2
    return {k: (np.concatenate([v[h:], v[:h]]) if isinstance(v, np.ndarray)
                else v[h:] + v[:h]) for k, v in batch.items()}


def _ddp_compare(name: str, want: dict, got: dict, tol: dict, card: str,
                 plain: dict = None, floor: dict = None) -> dict:
    """A rank's step against one process's: loss, metrics, gradients, BN.
    `plain` (bf16): one process's plain step, and `floor`: one process's on
    the halves-swapped batch; their distances are printed."""
    loss = abs(got["metrics"]["total"] - want["metrics"]["total"]) / abs(want["metrics"]["total"])
    metrics = max(abs(got["metrics"][k] - v) / max(abs(v), 1e-12)
                  for k, v in want["metrics"].items() if k != "total")
    dg = got["grads"].astype(np.float64) - want["grads"]
    grads = _grad_rel(got["grads"], want["grads"])
    bn = float(np.abs(got["bn"].astype(np.float64) - want["bn"]).max())
    out = {"loss_rel": loss, "metrics_rel": metrics, "grad_rel_l2": grads,
           "grad_max_abs": float(np.abs(dg).max()), "grad_max": float(np.abs(want["grads"]).max()),
           "bn_max_abs": bn}
    note = ""
    if plain is not None:
        out["plain"] = {
            "loss_rel": abs(got["metrics"]["total"] - plain["metrics"]["total"])
            / abs(plain["metrics"]["total"]),
            "grad_rel_l2": _grad_rel(got["grads"], plain["grads"]),
            "witness_grad_rel_l2": _grad_rel(want["grads"], plain["grads"]),
            "bn_max_abs": float(np.abs(got["bn"].astype(np.float64) - plain["bn"]).max())}
        note = (f"; against one process's plain bf16 step (bf16 batch_norm, unchecked): loss "
                f"rel {out['plain']['loss_rel']:.3e}, gradients rel L2 "
                f"{out['plain']['grad_rel_l2']:.3e} (the world-1 witness's own "
                f"{out['plain']['witness_grad_rel_l2']:.3e}), BN max abs diff "
                f"{out['plain']['bn_max_abs']:.3e}")
    if floor is not None:
        out["floor"] = {
            "loss_rel": abs(floor["metrics"]["total"] - want["metrics"]["total"])
            / abs(want["metrics"]["total"]),
            "grad_rel_l2": _grad_rel(floor["grads"], want["grads"]),
            "bn_max_abs": float(np.abs(floor["bn"].astype(np.float64) - want["bn"]).max())}
        note += (f"; bf16's floor, one process on the halves-swapped batch against it: loss "
                 f"rel {out['floor']['loss_rel']:.3e}, gradients rel L2 "
                 f"{out['floor']['grad_rel_l2']:.3e}, BN max abs diff "
                 f"{out['floor']['bn_max_abs']:.3e}")
    witness = " on the ranks' BatchNorm path" if plain is not None else ""
    log(f"ddp {name} step, 2 ranks (b8 each) vs one process b{DDP_BATCH}{witness} from the "
        f"same weights: loss rel {loss:.3e} (tolerance {tol['loss']:g}), other metrics rel "
        f"{metrics:.3e} ({tol['metrics']:g}), reduced gradients rel L2 {grads:.3e} "
        f"({tol['grads']:g}), max abs diff {out['grad_max_abs']:.3e} of max "
        f"{out['grad_max']:.3e}; BN running stats max abs diff {bn:.3e} ({tol['bn']:g})"
        f"{note} [{card}]")
    if not (loss <= tol["loss"] and metrics <= tol["metrics"] and grads <= tol["grads"]
            and bn <= tol["bn"]):
        raise AssertionError(f"ddp {name}: the 2-rank step differs from one process's")
    return out


def _ddp_nccl_world_one(card: str) -> dict:
    """A one-rank NCCL group on this card: init, one all-reduce, shutdown."""
    pdist.init_distributed(f"localhost:{pdist.free_port()}", 1, 0, backend="nccl")
    try:
        t = torch.arange(4, dtype=torch.float32, device="cuda")
        pdist.all_reduce_(t)
        torch.cuda.synchronize()
        ok = bool(torch.equal(t.cpu(), torch.arange(4, dtype=torch.float32)))
        backend = torch.distributed.get_backend()
    finally:
        pdist.shutdown()
    log(f"ddp: NCCL with more than one rank was not run on this machine "
        f"({torch.cuda.device_count()} card); a world-1 NCCL group ({backend}) initialized, "
        f"all-reduced and shut down: {'ok' if ok else 'WRONG'} [{card}]")
    if not ok:
        raise AssertionError("ddp: the world-1 NCCL all-reduce is wrong")
    return {"nccl_world1": ok}


def _ddp_checks(card: str, label: str, devices, ranks, want: dict, data: str, job,
                tmp: str) -> dict:
    """The step checks, the ranks' checksums, and the 2-epoch run's
    launches, files and final COCO against one process's evaluate_model of
    its best checkpoint."""
    out = {label: {
        "fp32": _ddp_compare(f"{label} fp32", want["fp32"], ranks[0]["fp32"], DDP_FP32, card),
        "bf16": _ddp_compare(f"{label} bf16", want["bf16_global_bn"], ranks[0]["bf16"],
                             DDP_BF16, card, want["bf16"], want["bf16_global_bn_swapped"])}}
    for name in ("fp32", "bf16"):
        local = [r[name]["local_grads"] for r in ranks]
        summed = all(np.array_equal(local[0] + local[1], r[name]["grads"]) for r in ranks)
        out[label][name]["reduced_is_sum"] = summed
        log(f"ddp {label} {name}: each rank's reduced gradient ({local[0].size} fp32) "
            f"{'equals' if summed else 'DIFFERS FROM'} the sum of the two ranks' local "
            f"gradients bit for bit")
        if not summed:
            raise AssertionError(f"ddp {label} {name}: the reduced gradient is not the sum")
        digests = [r[name]["digest"] for r in ranks]
        log(f"ddp {label} {name}: after {DDP_STEPS} steps the ranks' parameters, EMA and "
            f"optimizer state are {'bitwise equal' if digests[0] == digests[1] else 'DIFFERENT'}"
            f" (sha256 {digests[0]['model'][:12]}.., counters {digests[0]['counters']})")
        if digests[0] != digests[1]:
            raise AssertionError(f"ddp {label} {name}: the ranks' states differ")
    calls = ranks[0]["bf16"]["calls"]
    n_bn = sum(isinstance(m, BatchNorm) for m in build_model_from_config(job["cfgs"]["bf16"])
               .modules())
    coll = ranks[0]["collective_ms"]
    out[label].update(calls_per_step=calls, batchnorms=n_bn, collective_ms=coll,
                      step_ms_world2=ranks[0]["bf16"]["step_ms"],
                      step_ms_world1=want["bf16"]["step_ms"],
                      step_ms_world1_ranks_batchnorm=want["bf16_global_bn"]["step_ms"])
    cards = (f"both ranks on {devices[0]}" if len(set(devices)) == 1
             else f"on {', '.join(devices)}")
    log(f"ddp {label}: one bf16 step makes {calls['all_reduce']} all-reduces (one a "
        f"BatchNorm forward and one a BatchNorm backward where the loss's gradient reaches, "
        f"{n_bn} BatchNorm modules; one gradient bucket of "
        f"{ranks[0]['bf16']['grads'].size} fp32; one of the metrics) "
        f"and {calls['broadcast']} broadcasts; gradient bucket all-reduce "
        f"{coll['grad_bucket']:.3f} ms, one BatchNorm's (192 floats) "
        f"{coll['batchnorm_96']:.3f} ms; step b{DDP_BATCH} bf16 {want['bf16']['step_ms']:.2f} ms "
        f"in one process (world 1), {want['bf16_global_bn']['step_ms']:.2f} ms in one process "
        f"on the ranks' BatchNorm path, {ranks[0]['bf16']['step_ms']:.2f} ms a rank at world 2 "
        f"(b8 each, {cards}) [{card}]")

    # the 2-epoch run joined to this group
    tr0, tr1 = ranks[0]["train"], ranks[1]["train"]
    log_dir = tr0["log_dir"]
    val_batches = -(-VAL_N // DDP_TRAIN["batch_size"])
    want_launches = (DDP_TRAIN["epochs"] + 1) * val_batches
    launches = [tr0["launches"], tr1["launches"]]
    rank1_dir = job["train_cfgs"][1]["logging"]["log_dir"]
    cfg = job["train_cfgs"][0]
    sd, _ = load_checkpoint(os.path.join(log_dir, "weights", "best_model_state.ckpt"))
    trainer = Trainer(build_model_from_config(cfg), cfg, device="cuda")
    variables = trainer.variables_from_flax(sd["params"], sd["batch_stats"])
    val_ds = YoloDataset(cfg["dataset"]["val_images"], cfg["dataset"]["val_labels"],
                         img_size=IMG, is_train=False, augment=False,
                         max_boxes=int(cfg["training"]["max_boxes"]))
    cuda_nms.LAUNCHES = 0
    single = evaluate_model(trainer, variables, DataLoader(val_ds, DDP_TRAIN["batch_size"],
                                                           shuffle=False, drop_last=False),
                            os.path.join(tmp, f"ddp_eval_{label}"), 3, IMG, run_bench=False)
    torch.cuda.synchronize()
    diff = max(abs(tr0["coco"][k] - v) for k, v in single["coco"].items())
    hist = tr0["history"]
    log(f"ddp {label} train_from_config data_parallel 2, {DDP_TRAIN['epochs']} epochs edge_n "
        f"@{IMG} b{DDP_TRAIN['batch_size']} (4 a rank) bf16 in {tr0['seconds']:.1f} s: train "
        f"loss {', '.join(f'{v:.4f}' for v in hist['train_loss'])}, val loss "
        f"{', '.join(f'{v:.4f}' for v in hist['val_loss'])}; nms_suppress launched {launches} "
        f"times by the ranks (expected {want_launches} each: {val_batches} val batch x "
        f"{DDP_TRAIN['epochs']} epochs + {val_batches} in evaluate_model); final AP "
        f"{tr0['coco']['AP']:.6f} AP50 {tr0['coco']['AP50']:.6f}, one process's evaluate_model "
        f"of its best checkpoint AP {single['coco']['AP']:.6f} AP50 "
        f"{single['coco']['AP50']:.6f} (max diff {diff:.3e}, tolerance {DDP_EVAL_TOL:g}; "
        f"{cuda_nms.LAUNCHES} launch); rank 1 wrote {'nothing' if not os.path.exists(rank1_dir) else 'FILES'} "
        f"[{card}]")
    if launches != [want_launches] * DDP_WORLD:
        raise AssertionError("ddp: validation did not go through the kernel on every rank")
    if not all(np.isfinite(hist["step_loss"] + hist["val_loss"])):
        raise AssertionError(f"ddp: non-finite loss {hist}")
    if tr1["coco"] != tr0["coco"] or diff > DDP_EVAL_TOL:
        raise AssertionError("ddp: the run's final COCO is not one process's")
    if os.path.exists(rank1_dir):
        raise AssertionError(f"ddp: rank 1 wrote {rank1_dir}")
    _check_run_dir(log_dir)
    out[label]["train"] = {"launches": launches, "seconds": tr0["seconds"], "coco": tr0["coco"],
                           "single_coco": single["coco"], "history": hist,
                           "calls": tr0["calls"]}
    return out


def _ddp_one_process(data: str) -> dict:
    """One process's b16 steps from the seeded weights, which the ranks are
    held against: plain fp32 and bf16, and bf16 on the ranks' BatchNorm path
    (on the batch and on its halves swapped)."""
    cfgs = {"fp32": _edge_n_train_config(data, amp=False),
            "bf16": _edge_n_train_config(data, amp=True)}
    weights = _seeded_flax_edge_n(cfgs["fp32"])
    batch = _first_batch(cfgs["fp32"], DDP_BATCH)
    want = {}
    for name, amp in (("fp32", False), ("bf16", True)):
        torch.backends.cudnn.allow_tf32 = amp
        torch.backends.cuda.matmul.allow_tf32 = amp
        want[name] = _ddp_step_run(cfgs[name], *weights, batch, None, "cuda", timed=amp)
    with _world_one_global_batchnorm():
        for key, b in (("bf16_global_bn", batch), ("bf16_global_bn_swapped",
                                                   _halves_swapped(batch))):
            want[key] = _ddp_step_run(cfgs["bf16"], *weights, b, None, "cuda",
                                      timed=key == "bf16_global_bn")
    torch.backends.cudnn.allow_tf32 = True
    return {"cfgs": cfgs, "weights": weights, "batch": batch, "want": want}


def _ddp_backend(card: str, backend: str, devices, one: dict, data: str, tmp: str) -> dict:
    """Two ranks over `backend` on `devices`: the step checks against `one`,
    then the 2-epoch train_from_config joined to their group."""
    train_cfgs = []
    for r in range(DDP_WORLD):
        c = load_configs(os.path.join(ROOT, "configs", "models", "edge_n.yaml"),
                         os.path.join(ROOT, "configs", "train", "standard_train.yaml"),
                         data, make_run_dir=False)
        c["training"].update(DDP_TRAIN, data_parallel=DDP_WORLD)
        c["logging"] = {"log_dir": os.path.join(tmp, f"ddp_{backend}_rank{r}")}
        train_cfgs.append(c)
    job = {"cfgs": one["cfgs"], "weights": one["weights"], "batch": one["batch"],
           "train_cfgs": train_cfgs}
    t0 = time.perf_counter()
    ranks = _ddp_spawn(backend, devices, job)
    log(f"ddp {backend}: 2 ranks on {', '.join(devices)} ran in "
        f"{time.perf_counter() - t0:.1f} s")
    return _ddp_checks(card, backend, devices, ranks, one["want"], data, job, tmp)


def phase_ddp(card: str, data: str, tmp: str):
    """Data-parallel training at edge_n @640's full width: 2 ranks on this
    card over gloo against one process (a b16 step in fp32 and bf16, the
    ranks' state after 3 steps), then a 2-epoch train_from_config with
    data_parallel 2 joined to the ranks' group; over NCCL with one rank a
    card when there are 2 cards."""
    one = _ddp_one_process(data)
    out = _ddp_backend(card, "gloo", ["cuda:0"] * DDP_WORLD, one, data, tmp)
    if torch.cuda.device_count() >= 2:
        out.update(_ddp_backend(card, "nccl", ["cuda:0", "cuda:1"], one, data, tmp))
    else:
        out.update(_ddp_nccl_world_one(card))
    out["launches"] = sum(out["gloo"]["train"]["launches"])
    return out


SP_WORLD = 2                     # n_data 1 x n_spatial 2
SP_IMG = 1280
SP_BATCH = 2
SP_STEPS = 3                     # steps before the ranks' state checksums
SP_TIME_STEPS = 2
SP_TRAIN_N, SP_VAL_N = 4, 2      # the 1280 x 1280 PNG set (the data is cut, not the width)
SP_TIMEOUT_S = 600
SP_MODEL = "configs/models/yololite_l.yaml"
SP_TRAIN = dict(epochs=1, batch_size=SP_BATCH, img_size=SP_IMG, augment=True, amp=True,
                use_p6=True, save_optimizer=False, num_workers=2, data_parallel=1)
# The mesh's ranks vs one process, each limit relative (BatchNorm running
# statistics: the largest difference over the largest value). fp32 (TF32
# off): the ddp phase's limits, the loss and metrics 1e-5, gradients 5e-4
# rel L2, BatchNorm 1e-5. This step's fp32 gradient is ill-conditioned: one
# process against itself on the batch with its two images swapped (the same
# sums in another order) moves it by 1.47e-2, and by 1.58e-2 on the ranks'
# BatchNorm formula, the assignment unchanged (NVIDIA H100 80GB HBM3 at 700
# W, PERF.md section 6); so a gradient limit is the larger of the fixed one
# and 2x that floor, measured in the same run, and fp64 holds the sharding
# itself strictly: the same step in fp64 (the loss stays fp32) to 1e-8 in
# the gradients (BatchNorm's running statistics to 1e-6: one process takes
# them in fp32). bf16 against one process on the ranks' BatchNorm path
# (`_world_one_global_batchnorm`): DDP_BF16's limits or 2x bf16's own floor
# (that process on the swapped batch), whichever is larger, for each
# quantity. Stated in PERF.md before the run that first held them.
SP_FP32 = {"loss": 1e-5, "metrics": 1e-5, "grads": 5e-4, "bn": 1e-5}
SP_FP64 = {"loss": 1e-6, "metrics": 1e-6, "grads": 1e-8, "bn": 1e-6}
SP_BF16 = {"loss": 5e-4, "metrics": 5e-3, "grads": 0.2, "bn": 5e-3}
SP_FLOOR_X = 2.0
SP_PRECISIONS = (("fp32", False, None), ("fp64", False, torch.float64), ("bf16", True, None))
SP_EVAL_BOX_TOL, SP_EVAL_SCORE_TOL = 1e-2, 1e-5   # phase_fp32's _match tolerances
SP_AP_TOL = 0.05                 # the 1-epoch runs' final AP, 1 x 2 vs one process
SP_EVAL_TOL = 1e-12              # the run's final COCO vs one process's evaluate_model


def _spatial_config(data: str, amp: bool, **training):
    cfg = load_configs(os.path.join(ROOT, SP_MODEL),
                       os.path.join(ROOT, "configs", "train", "standard_train.yaml"),
                       data, make_run_dir=False)
    cfg["training"].update(SP_TRAIN, amp=amp, **training)
    return cfg


def _spatial_batch(cfg, swapped: bool = False) -> dict:
    ds = YoloDataset(cfg["dataset"]["train_images"], cfg["dataset"]["train_labels"],
                     img_size=SP_IMG, is_train=True, augment=False,
                     max_boxes=int(cfg["training"]["max_boxes"]))
    idx = list(range(SP_BATCH))
    return collate([ds.get(i) for i in (idx[::-1] if swapped else idx)])


def _spatial_eval(cfg, params, stats, batch, dp, device: str) -> dict:
    """eval_step (decode, scores, batched_nms) of the weights on `batch`,
    fp32 (TF32 off): the detections and this process's nms_suppress
    launches."""
    trainer = Trainer(build_model_from_config(cfg), cfg, device=device, parallel=dp)
    variables = trainer.variables_from_flax(params, stats)
    rows = slice(None) if dp is None else dp.batch_rows(len(batch["image"]))
    b = trainer.put_batch({k: v[rows] for k, v in batch.items()})
    torch.cuda.synchronize()
    cuda_nms.LAUNCHES = 0
    pdist.reset_calls()
    metrics, dets = trainer.eval_step(variables, b)
    torch.cuda.synchronize()
    host = {k: v.cpu().numpy() for k, v in dets.items()}
    return {"launches": cuda_nms.LAUNCHES, "calls": dict(pdist.CALLS),
            "total": float(metrics["total"]), "first": rows.start or 0,
            "dets": [(host["boxes"][i][host["valid"][i]], host["scores"][i][host["valid"][i]],
                      host["classes"][i][host["valid"][i]]) for i in range(len(host["boxes"]))]}


def _spatial_rank(rank: int, port: int, backend: str, devices, n_spatial: int, job) -> dict:
    """One rank of the spatial phase: the steps, the eval step, then (with
    gloo) train_from_config joined to this group."""
    world = len(devices)
    os.environ["LOCAL_RANK"], os.environ["LOCAL_WORLD_SIZE"] = str(rank), str(world)
    device = devices[rank]
    torch.cuda.set_device(device)
    pdist.init_distributed(f"localhost:{port}", world, rank, backend=backend)
    try:
        dp = pdist.DataParallel.from_group(n_spatial)
        res = {"backend": backend}
        for name, amp, dtype in SP_PRECISIONS:
            torch.backends.cudnn.allow_tf32 = amp
            torch.backends.cuda.matmul.allow_tf32 = amp
            res[name] = _ddp_step_run(job["cfgs"][name], *job["weights"], job["batch"], dp,
                                      device, timed=amp, steps=SP_STEPS,
                                      time_steps=SP_TIME_STEPS, dtype=dtype)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        res["eval"] = _spatial_eval(job["cfgs"]["fp32"], *job["weights"], job["batch"], dp,
                                    device)
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        if job.get("train_cfgs"):
            cuda_nms.LAUNCHES = 0
            pdist.reset_calls()
            t0 = time.perf_counter()
            train = train_loop.train_from_config(job["train_cfgs"][rank], device=device)
            torch.cuda.synchronize()
            res["train"] = {"launches": cuda_nms.LAUNCHES,
                            "seconds": time.perf_counter() - t0, "coco": train.get("coco"),
                            "history": train.get("history"), "log_dir": train.get("log_dir"),
                            "calls": dict(pdist.CALLS)}
    finally:
        pdist.shutdown()
    return res


def _spatial_one_process(data: str) -> dict:
    """One process's b2 steps from the seeded, calibrated weights, which the
    ranks are held against: fp32 (the batch, and its two images swapped),
    fp64; bf16 on the ranks' BatchNorm path (the batch, its images swapped)
    and plain; the eval step."""
    cfgs = {"fp32": _spatial_config(data, amp=False), "fp64": _spatial_config(data, amp=False),
            "bf16": _spatial_config(data, amp=True)}
    batch = _spatial_batch(cfgs["fp32"])
    swapped = _spatial_batch(cfgs["fp32"], True)
    t0 = time.perf_counter()
    model = init_weights(build_model_from_config(cfgs["fp32"]), seed=0).cuda().eval()
    images = torch.from_numpy(batch["image"]).cuda()
    calibrate_batchnorm(model, normalize_images(images.permute(0, 3, 1, 2)))
    weights = to_flax(model.cpu())
    log(f"spatial: {SP_MODEL} use_p6 @{SP_IMG}, {count_params(model)} params, seeded "
        f"with BatchNorm statistics from one forward of the b{SP_BATCH} batch in "
        f"{time.perf_counter() - t0:.1f} s")
    want = {}
    for name, amp, dtype in SP_PRECISIONS:
        torch.backends.cudnn.allow_tf32 = amp
        torch.backends.cuda.matmul.allow_tf32 = amp
        want[name] = _ddp_step_run(cfgs[name], *weights, batch, None, "cuda", timed=amp,
                                   steps=SP_STEPS, time_steps=SP_TIME_STEPS, dtype=dtype)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    want["fp32_swapped"] = _ddp_step_run(cfgs["fp32"], *weights, swapped, None, "cuda",
                                         timed=False, steps=1)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    with _world_one_global_batchnorm():
        for key, b in (("bf16_global_bn", batch), ("bf16_global_bn_swapped", swapped)):
            want[key] = _ddp_step_run(cfgs["bf16"], *weights, b, None, "cuda",
                                      timed=key == "bf16_global_bn", steps=SP_STEPS,
                                      time_steps=SP_TIME_STEPS)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    want["eval"] = _spatial_eval(cfgs["fp32"], *weights, batch, None, "cuda")
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    return {"cfgs": cfgs, "weights": weights, "batch": batch, "want": want}


def _step_gaps(got: dict, want: dict) -> dict:
    """Relative distances of a step from another: loss, the other metrics
    (the largest), gradients (rel L2), BN running stats (over their max)."""
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-12)
    return {"loss": rel(got["metrics"]["total"], want["metrics"]["total"]),
            "metrics": max(rel(got["metrics"][k], v) for k, v in want["metrics"].items()
                           if k != "total"),
            "grads": _grad_rel(got["grads"], want["grads"]),
            "bn": float(np.abs(got["bn"].astype(np.float64) - want["bn"]).max()
                        / np.abs(want["bn"]).max())}


def _spatial_compare(name: str, want: dict, got: dict, tol: dict, card: str,
                     floor: dict = None, witness: str = "") -> dict:
    """A rank's step against one process's; with `floor` (that process on
    the batch with its images swapped) each limit is the larger of `tol`'s
    and SP_FLOOR_X times the floor's distance."""
    gaps = _step_gaps(got, want)
    floors = _step_gaps(floor, want) if floor is not None else {}
    limits = {k: max(tol[k], SP_FLOOR_X * floors.get(k, 0.0)) for k in gaps}
    note = ""
    if floor is not None:
        note = ("; one process with the batch's two images swapped (the floor): "
                + ", ".join(f"{k} {v:.3e}" for k, v in floors.items()))
    log(f"spatial {name} step, the mesh's ranks (each its share of the image height) vs "
        f"one process{witness}, b{SP_BATCH} @{SP_IMG}: loss rel {gaps['loss']:.3e} (limit "
        f"{limits['loss']:.3g}), other metrics rel {gaps['metrics']:.3e} "
        f"({limits['metrics']:.3g}), reduced gradients rel L2 {gaps['grads']:.3e} "
        f"({limits['grads']:.3g}), BN running stats max diff / max {gaps['bn']:.3e} "
        f"({limits['bn']:.3g}){note} [{card}]")
    if any(gaps[k] > limits[k] for k in gaps):
        raise AssertionError(f"spatial {name}: the mesh's step differs from one process's")
    return {"gaps": gaps, "floor": floors, "limits": limits}


def _spatial_dets_equal(label: str, want: dict, got: dict, card: str) -> dict:
    """The mesh's eval_step detections (of its data index's images) against
    one process's: both ways matched within the _match tolerances, the kept
    counts equal."""
    mine = want["dets"][got["first"]:got["first"] + len(got["dets"])]
    fwd, n_got = _match(got["dets"], mine, SP_EVAL_BOX_TOL, SP_EVAL_SCORE_TOL)
    back, n_want = _match(mine, got["dets"], SP_EVAL_BOX_TOL, SP_EVAL_SCORE_TOL)
    counts = ([len(d[0]) for d in got["dets"]], [len(d[0]) for d in mine])
    log(f"spatial {label} eval_step (decode, batched_nms), fp32: {n_got} / {n_want} kept "
        f"detections a rank / one process ({counts[0]} / {counts[1]} an image), matched "
        f"{fwd:.4f} and {back:.4f} both ways (boxes {SP_EVAL_BOX_TOL:g} px, scores "
        f"{SP_EVAL_SCORE_TOL:g}); val loss rel "
        f"{abs(got['total'] - want['total']) / abs(want['total']):.3e}; nms_suppress "
        f"launches {got['launches']} a rank, {want['launches']} in one process [{card}]")
    if n_got == 0 or counts[0] != counts[1] or fwd < 1.0 or back < 1.0:
        raise AssertionError(f"spatial {label}: the eval step's kept detections differ")
    if got["launches"] < 1:
        raise AssertionError(f"spatial {label}: eval_step did not launch nms_suppress")
    return {"kept": n_got, "matched": [fwd, back], "launches": got["launches"]}


def _spatial_checks(card: str, label: str, devices, n_spatial: int, ranks, one: dict,
                    tmp: str) -> dict:
    """The step, eval and state checks of one backend's ranks; with gloo the
    1-epoch run against one process's."""
    want = one["want"]
    out = {"fp32": _spatial_compare(f"{label} fp32", want["fp32"], ranks[0]["fp32"],
                                    SP_FP32, card, want["fp32_swapped"]),
           "fp64": _spatial_compare(f"{label} fp64", want["fp64"], ranks[0]["fp64"],
                                    SP_FP64, card),
           "bf16": _spatial_compare(f"{label} bf16", want["bf16_global_bn"],
                                    ranks[0]["bf16"], SP_BF16, card,
                                    want["bf16_global_bn_swapped"],
                                    " on the ranks' BatchNorm path")}
    bn_path = _step_gaps(want["bf16"], want["bf16_global_bn"])
    log(f"spatial {label} bf16: one process's plain step (bf16 batch_norm, unchecked) "
        f"against its step on the ranks' BatchNorm path: " +
        ", ".join(f"{k} {v:.3e}" for k, v in bn_path.items()))
    out["bf16"]["plain_vs_witness"] = bn_path
    digests = [r["fp64"]["digest"] for r in ranks]
    if any(d != digests[0] for d in digests):
        raise AssertionError(f"spatial {label} fp64: the ranks' states differ")
    for name in ("fp32", "bf16"):
        # two ranks: the reduced gradient is a + b bit for bit; more: the
        # collective's own order of the sum, so within fp32 rounding of it
        local = [r[name]["local_grads"] for r in ranks]
        if len(ranks) == 2:
            total, how = local[0] + local[1], "bit for bit"
            summed = all(np.array_equal(total, r[name]["grads"]) for r in ranks)
        else:
            total, how = np.sum(np.stack(local).astype(np.float64), 0), "to 1e-6 relative"
            summed = all(np.allclose(r[name]["grads"], total, rtol=1e-6,
                                     atol=1e-6 * np.abs(total).max()) for r in ranks)
        digests = [r[name]["digest"] for r in ranks]
        same = all(d == digests[0] for d in digests)
        log(f"spatial {label} {name}: each rank's reduced gradient ({total.size} fp32) "
            f"{'equals' if summed else 'DIFFERS FROM'} the sum of the ranks' local gradients "
            f"{how}; after {SP_STEPS} steps the ranks' parameters, EMA and optimizer "
            f"state are {'bitwise equal' if same else 'DIFFERENT'} (sha256 "
            f"{digests[0]['model'][:12]}.., counters {digests[0]['counters']})")
        if not summed or not same:
            raise AssertionError(f"spatial {label} {name}: reduction or ranks' states differ")
        out[name]["reduced_is_sum"], out[name]["ranks_equal"] = summed, same
    calls = ranks[0]["bf16"]["calls"]
    peaks = [r["bf16"]["peak_bytes"] for r in ranks]
    out.update(calls_per_step=calls, peak_bytes=peaks,
               peak_bytes_world1=want["bf16"]["peak_bytes"],
               peak_bytes_world1_ranks_batchnorm=want["bf16_global_bn"]["peak_bytes"],
               step_ms=[r["bf16"]["step_ms"] for r in ranks],
               step_ms_world1=want["bf16"]["step_ms"],
               step_ms_world1_ranks_batchnorm=want["bf16_global_bn"]["step_ms"])
    cards = (f"all ranks on {devices[0]}" if len(set(devices)) == 1
             else f"on {', '.join(devices)}")
    log(f"spatial {label}: one bf16 step makes {calls['halo']} halo all-gathers "
        f"({calls['halo_bytes'] / 1e6:.2f} MB received a rank), {calls['gather']} output "
        f"gathers ({calls['gather_bytes'] / 1e6:.2f} MB), {calls['all_reduce']} all-reduces; "
        f"peak {', '.join(f'{p / 2**30:.2f}' for p in peaks)} GiB a rank against "
        f"{want['bf16']['peak_bytes'] / 2**30:.2f} GiB in one process "
        f"({want['bf16_global_bn']['peak_bytes'] / 2**30:.2f} on the ranks' BatchNorm path); "
        f"step b{SP_BATCH} "
        f"bf16 {want['bf16']['step_ms']:.1f} ms in one process, "
        f"{want['bf16_global_bn']['step_ms']:.1f} ms on the ranks' BatchNorm path, "
        f"{', '.join('%.1f' % r['bf16']['step_ms'] for r in ranks)} ms a rank "
        f"({cards}) [{card}]")
    out["eval"] = [_spatial_dets_equal(f"{label} rank {i}", want["eval"], r["eval"], card)
                   for i, r in enumerate(ranks)]
    if "train" not in ranks[0]:
        return out
    tr0 = ranks[0]["train"]
    launches = [r["train"]["launches"] for r in ranks]
    val_batches = -(-SP_VAL_N // SP_BATCH)
    want_launches = (SP_TRAIN["epochs"] + 1) * val_batches
    cfg = one["train_single"]["cfg"]
    sd, _ = load_checkpoint(os.path.join(tr0["log_dir"], "weights", "best_model_state.ckpt"))
    trainer = Trainer(build_model_from_config(cfg), cfg, device="cuda")
    variables = trainer.variables_from_flax(sd["params"], sd["batch_stats"])
    val_ds = YoloDataset(cfg["dataset"]["val_images"], cfg["dataset"]["val_labels"],
                         img_size=SP_IMG, is_train=False, augment=False,
                         max_boxes=int(cfg["training"]["max_boxes"]))
    same = evaluate_model(trainer, variables, DataLoader(val_ds, SP_BATCH, shuffle=False,
                                                         drop_last=False),
                          os.path.join(tmp, f"spatial_eval_{label}"), 3, SP_IMG,
                          run_bench=False)
    diff = max(abs(tr0["coco"][k] - v) for k, v in same["coco"].items())
    single = one["train_single"]["results"]
    ap_diff = abs(tr0["coco"]["AP"] - single["coco"]["AP"])
    hist = tr0["history"]
    log(f"spatial {label} train_from_config spatial_parallel {SP_WORLD}, 1 epoch "
        f"{SP_MODEL} use_p6 @{SP_IMG} b{SP_BATCH} bf16 on {SP_TRAIN_N} + {SP_VAL_N} PNGs at "
        f"{SP_IMG}x{SP_IMG} in {tr0['seconds']:.1f} s (one process "
        f"{one['train_single']['seconds']:.1f} s): step losses "
        f"{', '.join(f'{v:.4f}' for v in hist['step_loss'])} (one process "
        f"{', '.join(f'{v:.4f}' for v in single['history']['step_loss'])}), val loss "
        f"{hist['val_loss'][0]:.4f} ({single['history']['val_loss'][0]:.4f}); final AP "
        f"{tr0['coco']['AP']:.6f} AP50 {tr0['coco']['AP50']:.6f}, one process's run AP "
        f"{single['coco']['AP']:.6f} AP50 {single['coco']['AP50']:.6f} (|diff| {ap_diff:.3e}, "
        f"bound {SP_AP_TOL:g}); one process's evaluate_model of the run's best checkpoint "
        f"max diff {diff:.3e} (tolerance {SP_EVAL_TOL:g}); nms_suppress launched {launches} "
        f"times by the ranks (expected {want_launches} each) [{card}]")
    if launches != [want_launches] * len(ranks):
        raise AssertionError("spatial: validation did not go through the kernel on each rank")
    if not all(np.isfinite(hist["step_loss"] + hist["val_loss"])):
        raise AssertionError(f"spatial: non-finite loss {hist}")
    if any(r["train"]["coco"] != tr0["coco"] for r in ranks) or diff > SP_EVAL_TOL:
        raise AssertionError("spatial: the run's final COCO is not one process's evaluation")
    if ap_diff > SP_AP_TOL:
        raise AssertionError("spatial: the run's final AP is off one process's run")
    _check_run_dir(tr0["log_dir"])
    out["train"] = {"launches": launches, "seconds": tr0["seconds"], "coco": tr0["coco"],
                    "single_coco": single["coco"], "history": hist, "calls": tr0["calls"],
                    "single_seconds": one["train_single"]["seconds"]}
    return out


def _spatial_backend(card: str, backend: str, devices, n_spatial: int, one: dict,
                     data: str, tmp: str) -> dict:
    job = {"cfgs": one["cfgs"], "weights": one["weights"], "batch": one["batch"]}
    if backend == "gloo":
        job["train_cfgs"] = []
        for r in range(len(devices)):
            c = _spatial_config(data, amp=True, spatial_parallel=n_spatial)
            c["logging"] = {"log_dir": os.path.join(tmp, f"spatial_rank{r}")}
            job["train_cfgs"].append(c)
    t0 = time.perf_counter()
    ranks = pdist.spawn(_spatial_rank, (pdist.free_port(), backend, devices, n_spatial, job),
                        len(devices), timeout=SP_TIMEOUT_S)
    n_data = len(devices) // n_spatial
    log(f"spatial {backend}: mesh {n_data} x {n_spatial} on {', '.join(devices)} ran in "
        f"{time.perf_counter() - t0:.1f} s")
    return _spatial_checks(card, backend, devices, n_spatial, ranks, one, tmp)


def phase_spatial(card: str, tmp: str):
    """Spatial parallelism at yololite_l + P6 @1280's full width and depth:
    2 ranks on this card over gloo, each half the image height, against one
    process (a b2 step in fp32 and bf16, the ranks' state after 3 steps,
    the eval step's detections), then a 1-epoch train_from_config with
    spatial_parallel 2 joined to the ranks' group against one process's run;
    over NCCL, a rank a card, when there are 2 or more cards (2 x 2 on 4)."""
    t0 = time.perf_counter()
    data = make_synth_set(os.path.join(tmp, "synth1280"), SP_TRAIN_N, SP_VAL_N, w=SP_IMG,
                          h=SP_IMG)
    log(f"spatial: wrote {SP_TRAIN_N} + {SP_VAL_N} PNG images at {SP_IMG}x{SP_IMG} in "
        f"{time.perf_counter() - t0:.2f} s")
    one = _spatial_one_process(data)
    cfg = _spatial_config(data, amp=True)
    cfg["logging"] = {"log_dir": os.path.join(tmp, "spatial_single")}
    t0 = time.perf_counter()
    res = train_loop.train_from_config(cfg, device="cuda")
    torch.cuda.synchronize()
    one["train_single"] = {"cfg": cfg, "results": res, "seconds": time.perf_counter() - t0}
    out = {"gloo": _spatial_backend(card, "gloo", ["cuda:0"] * SP_WORLD, SP_WORLD, one, data,
                                    tmp)}
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        devices = [f"cuda:{i}" for i in range(4 if n_cards >= 4 else 2)]
        out["nccl"] = _spatial_backend(card, "nccl", devices, 2, one, data, tmp)
    else:
        log(f"spatial: NCCL was not run ({n_cards} card; NCCL refuses two ranks on one card)")
    out["launches"] = (sum(out["gloo"]["train"]["launches"])
                       + sum(e["launches"] for e in out["gloo"]["eval"]))
    return out


def _decode_scores(outs):
    d = decode_anchorfree([o.float() for o in outs], IMG)
    scores, classes = yolo_scores(d["obj"][..., 0], d["cls"])
    return d["box"], scores, classes


def main():
    card = phase_device()
    phase_build()
    krows, max_err = phase_kernels(card)
    fp32 = phase_fp32(card)
    serve = phase_serve(card)
    t_zoo = time.perf_counter()
    zoo = phase_zoo(card)
    log(f"zoo: {len(zoo)} configs in {time.perf_counter() - t_zoo:.1f} s")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        data = make_synth_set(os.path.join(tmp, "synth"), TRAIN_N, VAL_N)
        log(f"wrote {TRAIN_N} + {VAL_N} PNG images at 640x480 in "
            f"{time.perf_counter() - t0:.2f} s")
        phases = {}
        for name, fn in (("augment", lambda: phase_augment(card, data)),
                         ("train", lambda: phase_train(card, data, tmp)),
                         ("device_augment", lambda: phase_device_augment(card, data, tmp)),
                         ("seg", lambda: phase_seg(card, tmp)),
                         ("codecs", lambda: phase_codecs(card, data, tmp)),
                         ("stream", lambda: phase_stream(card)),
                         ("export", lambda: phase_export(card, tmp)),
                         ("quant", lambda: phase_quant(card, data, tmp)),
                         ("cli", lambda: phase_cli(card, data, tmp)),
                         ("draw", lambda: phase_draw(card, data, tmp, phases["cli"])),
                         ("video", lambda: phase_video(card, tmp, phases["cli"],
                                                       phases["draw"])),
                         ("tools", lambda: phase_tools(card, data, tmp, serve)),
                         ("synth", lambda: phase_synth(card, tmp)),
                         ("ddp", lambda: phase_ddp(card, data, tmp)),
                         ("spatial", lambda: phase_spatial(card, tmp))):
            t0 = time.perf_counter()
            phases[name] = fn()
            log(f"{name} phase: {time.perf_counter() - t0:.1f} s")
    train = phases["train"]
    main_k = krows[f"B{BATCH}_k{PRE_NMS_TOPK}"]
    kernels = [dict(KERNELS[0], launches=serve["launches"], max_abs_err=float(max_err),
                    ms=main_k["ms"], plain_ms=main_k["plain_ms"],
                    bound_ms=main_k["bound_ms"], bound_by=main_k["bound_by"],
                    library_ms=None, ms_mask=main_k["ms_mask"], ms_scan=main_k["ms_scan"],
                    ms_diou=main_k["ms_diou"], bound_ms_diou=main_k["bound_ms_diou"],
                    plain_ms_diou=main_k["plain_ms_diou"],
                    ms_diou_by_k={key: r["ms_diou"] for key, r in krows.items()},
                    ms_b1=krows[f"B1_k{PRE_NMS_TOPK}"]["ms"],
                    ms_by_k={key: r["ms"] for key, r in krows.items()},
                    launches_train=train["launches"],
                    launches_device_augment_train=phases["device_augment"]["nms_launches"],
                    launches_seg_serve={rel: r["launches"]
                                        for rel, r in phases["seg"]["serve"].items()},
                    launches_seg_train=phases["seg"]["train"]["launches"],
                    launches_jpeg_train=phases["codecs"]["train"]["launches"],
                    launches_tiff_train=phases["codecs"]["train_tiff"]["launches"],
                    launches_stream=phases["stream"]["launches"],
                    launches_export=phases["export"]["launches"],
                    launches_int8_serve=phases["quant"]["int8"]["launches"]["nms_suppress"],
                    launches_cli=phases["cli"]["launches"],
                    launches_draw=phases["draw"]["launches"],
                    launches_video=phases["video"]["launches"],
                    launches_tools=phases["tools"]["launches"],
                    launches_synth=phases["synth"]["launches"],
                    launches_diou=phases["synth"]["launches_diou"],
                    launches_ddp=phases["ddp"]["launches"],
                    launches_spatial=phases["spatial"]["launches"])]
    q = phases["quant"]["int8"]
    for k in KERNELS[1:]:
        t = q["totals"][k["name"]]
        kernels.append(dict(k, launches=q["launches"][k["name"]], max_abs_err=t["max_abs_err"],
                            ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                            bound_by=t["bound_by"], library_ms=t["library_ms"],
                            ms_1x1=t["ms_1x1"], calls_per_forward=t["calls"],
                            in_graph_ms=q["stages_ms"][k["name"].replace("_", " ")],
                            **({"yardstick_phase1_ms": t["yardstick_ms"]}
                               if "yardstick_ms" in t else {}),
                            launches_cli_evaluate_int8=phases["cli"]["evaluate_int8"][
                                "int8_launches"][k["name"]],
                            shape="edge_n b128 @640 bf16, summed over one forward"))
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "kernels_by_k": krows, "fp32": fp32,
                   "serve": serve, "zoo": zoo, **phases}, f, indent=1, default=float)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
