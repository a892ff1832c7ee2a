"""GPU smoke run of the PyTorch port's main paths, with its hand-written kernels.

    python3 chip_smoke.py

Needs one CUDA card, the CUDA toolkit (nvcc) and the repository checkout: it
builds the kernels from clownresampler_tpu_torch/ops/csrc (one nvcc per
source, all at once), holds each kernel against its plain PyTorch version on
the card, drives the public entry points -- the four reference goldens, a
1024-stream 48 kHz -> 44.1 kHz farm, a 1024-stream 96 kHz -> 48 kHz farm
(strided kernel), the config-5 mixed-ratio farm with a per-stream adjust,
the wide-kernel paths (44.1 kHz -> 132 Hz, and general ratios of 272 and
1016 taps), config 7's whole-stream scan (1024 stereo streams, 44.1 kHz ->
8 kHz) and the scans of the other three engines, each one device program
run with no host sync (a step is its engine's kernel in scan mode, which
reads the int16 chunks in place: one tiled_mac_kernel launch for the tiled
and general engines, one strided_mac_kernel launch for the strided one, a
wide_mac_kernel and a wide_fold_kernel launch for the wide one), farm
checkpoints restored on the card,
the CLI on the card, and config 5's fleet (1024 stereo streams, 8192 input
and 16,384 output frames each) as one resample_batch call, one
batch_mac_kernel launch -- then, with the launch counts reset, the sharded
paths on a mesh of four dp shards over the machine's cards in turn (one
card: four shards of it, each on its own CUDA stream): the headline farm,
the config-5 mixed farm with its per-stream adjust and the 44.1 kHz -> 132 Hz
farm as sharded farms, the lane-sharded tiled entry, the fleet's batch on a
(dp=2, sp=4) mesh, a sharded farm's checkpoint restored onto the mesh and
onto the card, and the multichip example as a subprocess. It checks that
every launch of those paths took a CUDA kernel, checks their outputs against
the gather oracle, the plain scan (every lane), the oracle scan and the
fleet's plain version, CPU replays and a golden md5, and every
stream of every sharded path against its unsharded counterpart; times the
kernels beside their bounds, the farms (sharded beside unsharded, each call
split into staging, launch and copy out, the caller dropping each output),
the pinned copy rates and the ways a result may reach the caller, the
fleet's resample_batch beside batch_mac_kernel alone, its plain version and
its bound (and the same at BATCH and at an oracle-scan step), batched
beside sharded and (at a quarter of the streams and an eighth of the
frames) beside a per-stream loop, the output de-interleave
three ways, and the scans (config 7's and the strided engine's ms a chunk,
the host's time to issue a step, peak memory, each engine's scan mode at its
step beside its bound); shows by torch.profiler that each
engine's step loop runs no aten op, allocates nothing and puts exactly its
kernels on the card, and that a steady farm call (unsharded, sharded, mixed)
runs no aten op and puts on the card its chunk's pieces' uploads (the farm
library's host threads copy each piece into pinned memory straight from the
caller's arrays) and one farm_stage_kernel, the engine's kernels, one
farm_unstage_kernel and one download a program; checks that every farm of the
main and sharded paths took its chunks straight from the caller's int16
arrays or stacked a mixed farm's streams, and that chunks of other types and
layouts, converted first, give the same outputs; counts
the device launches of one tiled, general, strided, wide and batch entry
call (one, one, one, two and one: each entry computes its own launch
geometry), and prints
one line per phase. It runs in about a minute of command time on an H100.
Its last line is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

Any failed phase raises, and the script then exits non-zero without that
line. It imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 20261016
ROOT = os.path.dirname(os.path.abspath(__file__))
PCM = os.path.join(ROOT, "tests", "fixtures", "test_pcm_s16le.raw")
GOLDENS = [  # (in, out, lpf, md5 of the s32le output): BASELINE.md
    (8000, 44100, 44100, "949de6c35cf5bd547e5a1e9a04233c14"),
    (8000, 44100, 8000, "949de6c35cf5bd547e5a1e9a04233c14"),
    (44100, 8000, 44100, "470b7980951007f7074affc666424004"),
    (44100, 8000, 8000, "470b7980951007f7074affc666424004"),
]
# The fleet: 1024 stereo streams, 48 kHz -> 44.1 kHz, ~8192 frames a launch.
FARM = dict(streams=1024, channels=2, rates=(48000, 44100), chunk=8916, chunks=8,
            sampled=(0, 1, 517, 1023))
# Config 2's ratio as a fleet: 1024 stereo streams, 96 kHz -> 48 kHz,
# 16,384-frame chunks (8192 output frames a launch, the strided kernel).
STRIDED_FARM = dict(streams=1024, channels=2, rates=(96000, 48000), chunk=16384, chunks=8,
                    sampled=(0, 333, 1023))
# Config 5 (benchmarks/run_all.py:403-430): four ratio groups x 256 stereo
# streams, chunks of 8192 frames; after chunk 3 one stream moves to
# 44.1 kHz -> 8 kHz (general kernel), so every group reserves its radius 17.
MIXED = dict(groups=((48000, 44100), (44100, 48000), (8000, 48000), (96000, 48000)),
             per_group=256, channels=2, chunk=8192, chunks=6, adjust_after=3,
             moved=5, moved_to=(44100, 8000), max_radius=17)
# Config 8's ratio (taps 2008) as a fleet: 256 stereo streams, 44.1 kHz ->
# 132 Hz, one second a chunk (the wide kernel).
WIDE_FARM = dict(streams=256, channels=2, rates=(44100, 132), chunk=44100, chunks=4,
                 sampled=(0, 255))
# General-class ratios past lowlevel.GENERAL_WIDE_MIN_TAPS (taps 272 and
# 1016), which resample_array sends to the wide kernel.
GENERAL_WIDE_RATES = ((44100, 1000), (44100, 262))
HEADLINE = dict(rates=(48000, 44100), lanes=2048, n_out=8192)
# An input rate per tiled (d, cand) class at 48 kHz out: the middle of the
# class's increment range (44.1k -> 44.1k is d = 1, cand = 1).
TILED_CLASSES = tuple((d, c, 48000 if c == 1 else round(48000 * (d + (c - 1.5) / 7)))
                      for d in (0, 1) for c in range(1, 9) if (d, c) != (0, 1))
# The tiled kernel against its plain version: (label, rates, n_out, x lanes,
# options). Options: p0/f0; ints (the state as Python ints instead of 0-dim
# device tensors); max_taps (a wider reserve than the ratio's); flat (the
# flat LUT instead of the strided one); cut (rows taken off x's end, so that
# the last frames' windows clamp); d/cand given to the entry (cand 1 for a
# cand-8 increment: windows past the stage, read from device memory);
# shard (the launch of dp shard i of SHARD_DP: SHARD_LANES lanes at
# i*SHARD_LANES, issued on a side CUDA stream); and the entry's clamp_s16,
# lanes and lane_offset; n_valid (and frame_offset): frames n with n +
# frame_offset >= n_valid come back 0 (given to the entry as a one-element
# device tensor, as a scan step's produced count is).
TILED_CASES = (
    ("48k->44.1k headline", (48000, 44100), 8192, 2048, {}),
    *((f"{a}->48k d={d} cand={c}", (a, 48000), 1024, 512, {}) for d, c, a in TILED_CLASSES),
    ("48k->44.1k p0=3 f0=12345", (48000, 44100), 8192, 2048, dict(p0=3, f0=12345)),
    ("48k->44.1k state as ints", (48000, 44100), 8192, 2048, dict(p0=3, f0=12345, ints=True)),
    ("48k->44.1k T=40 (radius-17 reserve)", (48000, 44100), 8192, 2048, dict(max_taps=40)),
    ("92.6k->48k d=1 cand=8 T=40", (92571, 48000), 4096, 2048, dict(max_taps=40)),
    ("48k->44.1k clamp_s16", (48000, 44100), 8192, 2048, dict(clamp_s16=True)),
    ("48k->44.1k lane slice 517+1000", (48000, 44100), 8192, 2048,
     dict(lanes=1000, lane_offset=517)),
    ("48k->44.1k n_out 8200", (48000, 44100), 8200, 2048, {}),
    ("48k->44.1k p0/f0 past 2^15, 40000 frames", (48000, 44100), 40000, 512,
     dict(p0=35651, f0=65535)),
    ("44.1k->48k clamped tail", (44100, 48000), 8192, 2048, dict(cut=40)),
    ("8k->44.1k flat LUT", (8000, 44100), 8192, 2048, dict(flat=True)),
    ("48k->44.1k T=48 (generic tap loop)", (48000, 44100), 2048, 512, dict(max_taps=48)),
    ("48k->44.1k T=400 (unstaged)", (48000, 44100), 1024, 512, dict(max_taps=400)),
    ("92.6k->48k given cand=1", (92571, 48000), 2048, 512, dict(cand=1)),
    ("48k->44.1k one stereo stream", (48000, 44100), 4096, 2, {}),
    ("48k->44.1k shard 1 of 4 on a side stream", (48000, 44100), 8192, 2048, dict(shard=1)),
    ("48k->44.1k n_valid 5000", (48000, 44100), 8192, 2048, dict(n_valid=5000)),
    ("48k->44.1k n_valid 4100 at frame offset 4096, clamp_s16, lane slice 517+1000",
     (48000, 44100), 8192, 2048,
     dict(n_valid=4100, frame_offset=4096, clamp_s16=True, lanes=1000, lane_offset=517)),
    ("48k->44.1k n_valid past the launch", (48000, 44100), 1024, 512, dict(n_valid=1 << 20)),
)
# The general entry (tiled_mac_kernel) against its plain version, options
# as TILED_CASES': d 2 (48k -> 22.05k, 16 taps), 4 (192k -> 44.1k, 32), 5
# (44.1k -> 8k, 40), 6 (44.1k -> 7k), 11 (44.1k -> 4k, 72: past the
# unrolled set) and 40 (44.1k -> 1100, 248: too wide to stage); f0 at 0,
# 0x8421 and 0xFFFF; the state as ints; lane slices at 517 (the unaligned
# path, staged and not); one stereo stream; the s16 clamp; clamped tails;
# the flat LUT; 8 (narrower than the ratio, its surplus taps dropped
# alike), 24, 48, 128 (staged at one block an SM) and 248 taps; a
# 16,384-frame launch.
GENERAL_CASES = (
    ("44.1k->8k 4096 x 2048", (44100, 8000), 4096, 2048, {}),
    ("44.1k->8k p0=1 f0=0x8421", (44100, 8000), 4096, 2048, dict(p0=1, f0=0x8421)),
    ("44.1k->8k state as ints f0=0xFFFF", (44100, 8000), 4096, 2048,
     dict(p0=3, f0=0xFFFF, ints=True)),
    ("44.1k->8k clamp_s16", (44100, 8000), 4096, 2048, dict(clamp_s16=True)),
    ("44.1k->8k lane slice 517+1000", (44100, 8000), 4096, 2048,
     dict(lanes=1000, lane_offset=517)),
    ("44.1k->8k clamped tail", (44100, 8000), 4096, 2048, dict(p0=2, cut=120)),
    ("44.1k->8k flat LUT", (44100, 8000), 4096, 2048, dict(f0=0x8421, flat=True)),
    ("44.1k->8k one stereo stream", (44100, 8000), 1536, 2, dict(f0=0xFFFF)),
    ("44.1k->8k 16384 frames", (44100, 8000), 16384, 512, dict(p0=35651, f0=0xFFFF)),
    ("44.1k->8k T=48 (generic tap loop)", (44100, 8000), 2048, 512, dict(max_taps=48)),
    ("44.1k->8k T=128 (one block an SM)", (44100, 8000), 2048, 512, dict(max_taps=128)),
    ("44.1k->8k T=248 lane slice 517+1000 (unstaged)", (44100, 8000), 1024, 2048,
     dict(max_taps=248, lanes=1000, lane_offset=517)),
    ("44.1k->7k d=6", (44100, 7000), 4096, 2048, dict(p0=1, f0=777)),
    ("48k->22.05k d=2", (48000, 22050), 4096, 2048, {}),
    ("48k->22.05k T=8", (48000, 22050), 4096, 2048, dict(max_taps=8, f0=0xFFFF)),
    ("48k->22.05k T=24 clamp_s16 clamped tail", (48000, 22050), 4096, 2048,
     dict(max_taps=24, clamp_s16=True, cut=60)),
    ("192k->44.1k d=4", (192000, 44100), 4096, 2048, dict(f0=0x8421)),
    ("192k->44.1k lane slice 517+1000 ints", (192000, 44100), 2048, 2048,
     dict(lanes=1000, lane_offset=517, ints=True)),
    ("44.1k->4k d=11 taps 72", (44100, 4000), 2048, 1024, dict(p0=5)),
    ("44.1k->1100 d=40 taps 248 (unstaged)", (44100, 1100), 1024, 512, dict(f0=0x8421)),
    ("44.1k->1100 flat LUT clamped tail", (44100, 1100), 512, 512,
     dict(flat=True, cut=600)),
    ("44.1k->8k shard 2 of 4 on a side stream", (44100, 8000), 4096, 2048,
     dict(f0=0x8421, shard=2)),
    ("44.1k->8k n_valid 1487 of 1536 (a scan step)", (44100, 8000), 1536, 2048,
     dict(p0=17, n_valid=1487)),
    ("44.1k->8k n_valid 0, one stereo stream", (44100, 8000), 1536, 2, dict(n_valid=0)),
    ("44.1k->1100 T=248 n_valid 300 at frame offset 200 (unstaged)", (44100, 1100), 1024, 512,
     dict(f0=0x8421, n_valid=300, frame_offset=200)),
)
STRIDED_RATIOS = ((96000, 48000), (192000, 48000), (132300, 44100), (529200, 44100))
# The strided kernel against its plain version: (label, rates, n_out, x
# lanes, options), options as TILED_CASES' (cut: frames of d rows taken off
# x's end). Every ratio of STRIDED_RATIOS (d 2, 4, 3 and 12; 529.2k -> 44.1k
# has 72 taps, past the unrolled set) as is, on a lane slice, clamped to s16
# and with a clamped tail; the state as ints at f0 65535; a reserve of 40
# taps for 12 live; 400 taps (too wide to stage); a stereo launch; 48k->8k.
STRIDED_CASES = (
    *((f"{a}->{b}{label}", (a, b), 8192, 2048, opts) for a, b in STRIDED_RATIOS
      for label, opts in (("", {}), (" lane slice 517+1000", dict(lanes=1000, lane_offset=517)),
                          (" p0=5 clamp_s16", dict(p0=5, clamp_s16=True)),
                          (" p0=5 clamped tail", dict(p0=5, cut=40)))),
    ("96k->48k state as ints p0=3 f0=65535", (96000, 48000), 8192, 2048,
     dict(p0=3, f0=65535, ints=True)),
    ("96k->48k T=40 (radius-17 reserve, 12 live)", (96000, 48000), 8192, 2048,
     dict(max_taps=40)),
    ("96k->48k T=400 (unstaged)", (96000, 48000), 2048, 512, dict(max_taps=400)),
    ("96k->48k one stereo stream", (96000, 48000), 4096, 2, {}),
    ("48k->8k d=6", (48000, 8000), 2048, 512, dict(p0=1)),
    ("96k->48k shard 3 of 4 on a side stream", (96000, 48000), 8192, 2048, dict(shard=3)),
    ("96k->48k n_valid 4105", (96000, 48000), 8192, 2048, dict(p0=12, n_valid=4105)),
    ("529.2k->44.1k n_valid 77 at frame offset 64, clamp_s16, one stereo stream",
     (529200, 44100), 4096, 2, dict(n_valid=77, frame_offset=64, clamp_s16=True)),
)
# The wide kernel against its plain version, as STRIDED_CASES (cut: rows
# 8d + 8 taken off x's end; flat: the flat LUT instead of the strided one):
# 272 to 6016 taps, f0 at 0x8421 and 0xFFFF; 44.1k -> 262 and 44.1k -> 1000
# are general ratios that resample_array sends to the wide kernel by width.
WIDE_RATES = (("44.1k->132 taps 2008", (44100, 132), 64, 1024, dict(p0=7, f0=0x8421)),
              ("44.1k->44 taps 6016", (44100, 44), 64, 256, dict(p0=3, f0=0x1111)),
              ("96k->480", (96000, 480), 64, 1024, dict(p0=5)),
              ("44.1k->262 taps 1016", (44100, 262), 64, 1024, dict(p0=9, f0=0x8421)),
              ("44.1k->1000 taps 272", (44100, 1000), 512, 1024, dict(p0=2, f0=0xFFFF)))
WIDE_CASES = (
    *((f"{label}{more}", rates, n_out, lanes, dict(opts, **extra))
      for label, rates, n_out, lanes, opts in WIDE_RATES
      for more, extra in (("", {}), (" clamp_s16", dict(clamp_s16=True)),
                          (" clamped tail", dict(cut=True)))),
    ("44.1k->132 state as ints f0=0xFFFF", (44100, 132), 64, 1024,
     dict(p0=4, f0=0xFFFF, ints=True)),
    ("44.1k->132 flat LUT", (44100, 132), 64, 1024, dict(p0=7, f0=0x8421, flat=True)),
    ("44.1k->132 lane slice 517+500", (44100, 132), 64, 1024, dict(lanes=500, lane_offset=517)),
    ("44.1k->132 one stereo stream", (44100, 132), 256, 2, dict(f0=0x8421)),
    ("44.1k->132 1024 frames x 512 lanes", (44100, 132), 1024, 512, {}),
    ("44.1k->132 shard 0 of 4 on a side stream", (44100, 132), 64, 2048,
     dict(f0=0x8421, shard=0)),
    ("44.1k->1000 taps 272 n_valid 186 of 256 (a scan step)", (44100, 1000), 256, 512,
     dict(p0=136, n_valid=186)),
    ("44.1k->132 n_valid 70 at frame offset 64, clamp_s16", (44100, 132), 64, 1024,
     dict(f0=0x8421, n_valid=70, frame_offset=64, clamp_s16=True)),
    # Edges of the frames a run meets and their taps gathered ahead: N off
    # a multiple of 8 (the plain version, which takes whole 8-frame tiles,
    # sliced to the kernel's N), a lane tile cut short (and lanes off 4: no
    # 16-byte path), 24 frames clamped at row_max, n_valid off a tile, one
    # lane tile of 1024 frames at 6016 taps, the flat LUT at 6016 taps, and
    # a 1024-tap reserve at 44.1k -> 1000: up to 25 frames a run, past the
    # 16 gathered with the run's rows (each warp fetches the rest itself).
    ("44.1k->132 60 of 64 frames", (44100, 132), 64, 1024, dict(f0=0x8421, frames=60)),
    ("44.1k->132 1000 lanes (a lane tile cut short)", (44100, 132), 64, 1000, dict(p0=3)),
    ("44.1k->132 1001 lanes, clamp_s16 (no 16-byte path)", (44100, 132), 64, 1001,
     dict(f0=0x1234, clamp_s16=True)),
    ("44.1k->132 24 frames clamped at row_max", (44100, 132), 64, 1024, dict(cut=24)),
    ("44.1k->132 n_valid 37", (44100, 132), 64, 1024, dict(f0=0x8421, n_valid=37)),
    ("44.1k->44 taps 6016 1024 frames x 16", (44100, 44), 1024, 16, dict(p0=1, f0=0x7777)),
    ("44.1k->44 taps 6016 flat LUT", (44100, 44), 64, 256, dict(f0=0xFFFF, flat=True)),
    ("44.1k->1000 taps 272 in a 1024-tap reserve (frames past those gathered ahead)",
     (44100, 1000), 256, 512, dict(p0=9, f0=0x0F0F, max_taps=1024)),
)
# A scan mode against its plain version, one scan_inplace_step a case (the
# engine's launches of one step): (label, rates, lanes, n_in, chunk type,
# step k, options). The chunks are K random chunks in one tensor (option
# chunks, default 3), so the rows past step k's chunk hold the next chunk's
# samples and a window that read them would differ; the step's state is (p +
# radius, f) (options p and f, default 0). Options: n_out (default as
# scan_case sizes it); offset (the chunks start that many elements past a
# 16-byte aligned address); flat (the flat LUT instead of the strided one);
# taps (a tap reserve other than the radius's); launch_frames (the wide
# engine's frames a launch, in place of wide_launch_frames: several launches
# a step). Each case's copy path (_build.scan_copy_path) is recorded with its
# chunk type, and every path of the table's *_PATHS must be taken.
# tiled_mac_kernel's scan mode (the tiled and general engines):
SCAN_INPLACE_CASES = (
    ("44.1k->8k config 7 step 0 int16 x 2048", (44100, 8000), 2048, 8192, torch.int16, 0, {}),
    ("44.1k->8k config 7 step 1 int16 x 2048 p=3 f=0x8421", (44100, 8000), 2048, 8192,
     torch.int16, 1, dict(p=3, f=0x8421)),
    ("44.1k->8k last step int32 x 2048", (44100, 8000), 2048, 8192, torch.int32, 2,
     dict(p=1, f=0xFFFF)),
    ("44.1k->8k int16 x 6 (4-byte copies)", (44100, 8000), 6, 4096, torch.int16, 1,
     dict(p=2, f=777)),
    ("44.1k->8k int16 x 5 (element loads)", (44100, 8000), 5, 4096, torch.int16, 1,
     dict(f=0x1111)),
    ("44.1k->8k int32 x 6 (4-byte copies)", (44100, 8000), 6, 4096, torch.int32, 2,
     dict(p=4, f=5)),
    ("44.1k->8k int16 x 2048, chunks 4 bytes off 16", (44100, 8000), 2048, 2048, torch.int16,
     1, dict(offset=2, f=0x4321)),
    ("44.1k->8k int16 x 512, chunks 2 bytes off 16 (element loads)", (44100, 8000), 512, 2048,
     torch.int16, 1, dict(offset=1)),
    ("44.1k->8k int32 x 512, chunks 4 bytes off 16", (44100, 8000), 512, 2048, torch.int32, 1,
     dict(offset=1, p=2)),
    ("44.1k->8k n_in 16 < 2r, step 0", (44100, 8000), 512, 16, torch.int16, 0, dict(chunks=6)),
    ("44.1k->8k n_in 16 < 2r, step 4", (44100, 8000), 512, 16, torch.int16, 4,
     dict(chunks=6, p=1, f=0x2222)),
    ("44.1k->8k flat LUT", (44100, 8000), 512, 2048, torch.int16, 1, dict(flat=True, f=99)),
    ("44.1k->4k taps 72 (generic tap loop)", (44100, 4000), 512, 4096, torch.int16, 1,
     dict(p=5, f=0x0F0F)),
    ("44.1k->1100 taps 248 (windows read from the stream) int16 x 512", (44100, 1100), 512,
     4096, torch.int16, 1, dict(p=3, f=0x8421)),
    ("44.1k->1100 taps 248 (windows read from the stream) int16 x 5", (44100, 1100), 5, 4096,
     torch.int16, 0, {}),
    ("48k->44.1k tiled int16 x 2048", (48000, 44100), 2048, 8192, torch.int16, 1,
     dict(p=1, f=12345)),
    ("48k->44.1k tiled n_in 3 < 2r int32 x 6", (48000, 44100), 6, 3, torch.int32, 2,
     dict(chunks=4)),
    ("8k->44.1k undersized n_out (over)", (8000, 44100), 512, 8192, torch.int16, 1,
     dict(n_out=8192)),
    ("44.1k->8k state past the chunk (nothing produced)", (44100, 8000), 512, 1024,
     torch.int16, 1, dict(p=1030, f=1)),
)
# strided_mac_kernel's scan mode (the strided engine; 96k -> 48k: d 2, radius
# 6, 16 taps of which 12 are live):
STRIDED_SCAN_CASES = (
    ("96k->48k step 0 int16 x 2048", (96000, 48000), 2048, 8192, torch.int16, 0, {}),
    ("96k->48k step 1 int16 x 2048 p=3 f=0x8421", (96000, 48000), 2048, 8192, torch.int16, 1,
     dict(p=3, f=0x8421)),
    ("96k->48k last step int32 x 2048", (96000, 48000), 2048, 8192, torch.int32, 2,
     dict(p=1, f=0xFFFF)),
    ("96k->48k int16 x 6 (4-byte copies)", (96000, 48000), 6, 4096, torch.int16, 1,
     dict(p=2, f=777)),
    ("96k->48k int16 x 5 (element loads)", (96000, 48000), 5, 4096, torch.int16, 1,
     dict(f=0x1111)),
    ("96k->48k int16 x 1001 (element loads)", (96000, 48000), 1001, 2048, torch.int16, 1,
     dict(p=1, f=5)),
    ("96k->48k int32 x 6 (4-byte copies)", (96000, 48000), 6, 4096, torch.int32, 2,
     dict(p=4, f=5)),
    ("96k->48k int16 x 2048, chunks 4 bytes off 16", (96000, 48000), 2048, 2048, torch.int16,
     1, dict(offset=2, f=0x4321)),
    ("96k->48k int16 x 512, chunks 2 bytes off 16 (element loads)", (96000, 48000), 512, 2048,
     torch.int16, 1, dict(offset=1)),
    ("96k->48k int32 x 512, chunks 4 bytes off 16", (96000, 48000), 512, 2048, torch.int32, 1,
     dict(offset=1, p=2)),
    ("96k->48k n_in 5 < 2r, step 0", (96000, 48000), 512, 5, torch.int16, 0, dict(chunks=6)),
    ("96k->48k n_in 5 < 2r, step 4", (96000, 48000), 512, 5, torch.int16, 4,
     dict(chunks=6, p=1, f=0x2222)),
    ("132.3k->44.1k d 3 int16 x 512", (132300, 44100), 512, 4096, torch.int16, 1,
     dict(p=2, f=0x0F0F)),
    ("96k->48k 40-tap reserve over 12 live int16 x 2048", (96000, 48000), 2048, 4096,
     torch.int16, 1, dict(taps=40, f=0x0707)),
    ("529.2k->44.1k d 12 taps 72 (generic tap loop)", (529200, 44100), 512, 4096, torch.int16,
     1, dict(p=5, f=0x8421)),
    ("96k->48k 1024-tap reserve (windows read from the stream) int16 x 512", (96000, 48000),
     512, 2048, torch.int16, 1, dict(taps=1024, p=3)),
    ("96k->48k 1024-tap reserve (windows read from the stream) int16 x 5", (96000, 48000), 5,
     2048, torch.int16, 0, dict(taps=1024)),
    ("96k->48k undersized n_out (over)", (96000, 48000), 512, 4096, torch.int16, 1,
     dict(n_out=1024)),
    ("96k->48k state past the chunk (nothing produced)", (96000, 48000), 512, 1024,
     torch.int16, 1, dict(p=1030, f=1)),
)
# wide_mac_kernel and wide_fold_kernel's scan mode (the wide engine; 44.1k ->
# 1000: radius 136, 272 taps, d 44):
WIDE_SCAN_CASES = (
    ("44.1k->1000 step 0 int16 x 512", (44100, 1000), 512, 8192, torch.int16, 0, {}),
    ("44.1k->1000 step 1 int16 x 512 p=9 f=0x8421", (44100, 1000), 512, 8192, torch.int16, 1,
     dict(p=9, f=0x8421)),
    ("44.1k->1000 last step int32 x 512", (44100, 1000), 512, 8192, torch.int32, 2,
     dict(p=1, f=0xFFFF)),
    ("44.1k->1000 int16 x 6 (4-byte copies)", (44100, 1000), 6, 4096, torch.int16, 1,
     dict(p=2, f=777)),
    ("44.1k->1000 int16 x 5 (element loads)", (44100, 1000), 5, 4096, torch.int16, 1,
     dict(f=0x1111)),
    ("44.1k->1000 int16 x 1001 (element loads)", (44100, 1000), 1001, 2048, torch.int16, 1,
     dict(p=3, f=9)),
    ("44.1k->1000 int32 x 6 (4-byte copies)", (44100, 1000), 6, 4096, torch.int32, 2,
     dict(p=4, f=5)),
    ("44.1k->1000 int16 x 512, chunks 4 bytes off 16", (44100, 1000), 512, 4096, torch.int16,
     1, dict(offset=2, f=0x4321)),
    ("44.1k->1000 int16 x 512, chunks 2 bytes off 16 (element loads)", (44100, 1000), 512,
     4096, torch.int16, 1, dict(offset=1)),
    ("44.1k->1000 int32 x 512, chunks 4 bytes off 16", (44100, 1000), 512, 4096, torch.int32,
     1, dict(offset=1, p=2)),
    ("44.1k->1000 n_in 128 < 2r, step 0", (44100, 1000), 512, 128, torch.int16, 0,
     dict(chunks=6)),
    ("44.1k->1000 n_in 128 < 2r, step 4 int32 x 6", (44100, 1000), 6, 128, torch.int32, 4,
     dict(chunks=6, p=140, f=0x1111)),
    ("44.1k->1000 launches at 0, 96, 192", (44100, 1000), 512, 8192, torch.int16, 1,
     dict(p=9, f=0x8421, n_out=256, launch_frames=96)),
    ("44.1k->262 taps 1016 int16 x 512", (44100, 262), 512, 8192, torch.int16, 1,
     dict(p=7, f=0x0F0F)),
    ("44.1k->1000 undersized n_out (over)", (44100, 1000), 512, 8192, torch.int16, 1,
     dict(n_out=64)),
    ("44.1k->1000 state past the chunk (nothing produced)", (44100, 1000), 512, 1024,
     torch.int16, 1, dict(p=1030, f=1)),
    # Edges as WIDE_CASES': a lane tile cut short, the flat LUT, 16 lane
    # tiles at 1016 taps, and a 1024-tap reserve (frames a run past those
    # gathered ahead).
    ("44.1k->1000 int16 x 200 (a lane tile cut short)", (44100, 1000), 200, 4096,
     torch.int16, 1, dict(p=5, f=0x2468)),
    ("44.1k->1000 flat LUT int32 x 512", (44100, 1000), 512, 4096, torch.int32, 1,
     dict(p=6, f=0x0ABC, flat=True)),
    ("44.1k->262 taps 1016 int16 x 2048", (44100, 262), 2048, 8192, torch.int16, 1,
     dict(p=2, f=0x0F0F)),
    ("44.1k->1000 int16 x 512, 1024-tap reserve (frames past those gathered ahead)",
     (44100, 1000), 512, 8192, torch.int16, 1, dict(p=4, f=0x3C3C, taps=1024)),
)
SCAN_COPY_NAMES = ("element loads", "4-byte copies", "16-byte copies")  # by SCAN_COPY_*
SCAN_INPLACE_PATHS = frozenset(
    [f"int16 {name}" for name in SCAN_COPY_NAMES]
    + [f"int32 {name}" for name in SCAN_COPY_NAMES[1:]])
# The strided scan mode also reads windows too wide to stage from the stream;
# the wide one also cuts a step into several launches.
STRIDED_SCAN_PATHS = SCAN_INPLACE_PATHS | {"windows read from the stream"}
WIDE_SCAN_PATHS = SCAN_INPLACE_PATHS | {"several launches a step"}
# Each scan mode's case table, its copy paths and its kernel's name.
SCAN_MODE_CASES = (("tiled_mac_kernel/scan", SCAN_INPLACE_CASES, SCAN_INPLACE_PATHS),
                   ("strided_mac_kernel/scan", STRIDED_SCAN_CASES, STRIDED_SCAN_PATHS),
                   ("wide_mac_kernel/scan", WIDE_SCAN_CASES, WIDE_SCAN_PATHS))
# farm_stage_kernel against its plain version, one launch a case: (label,
# streams, channels, capacity rows, chunk frames n, keep, consumed, options).
# Rows [0, keep) of the destination come from rows [consumed, consumed +
# keep) of the other buffer, rows [keep, keep + n) are the chunk, the rest
# zero; both buffers start full of other values. Options: in_place (one
# buffer, nothing consumed); shard (streams [shard*B, (shard+1)*B) of a
# chunk of SHARD_DP*B streams, as a mesh shard uploads them, on a side CUDA
# stream); chunk_offset: the chunk starts that many int16 elements past an
# aligned address. Each case's path (_build.farm_stage_path) is recorded, and
# every path must be taken.
FARM_SHAPES = tuple((b, c) for b in (1, 6, 64) for c in (1, 2, 3, 16))
FARM_STAGE_CASES = (
    ("headline 1024 x 2, 8916 frames, slide of 8912 parked", 1024, 2, 8932, 8916, 12, 8912, {}),
    ("headline first call, in place", 1024, 2, 8932, 8916, 4, 0, dict(in_place=True)),
    ("headline short chunk of 100 in place", 1024, 2, 8932, 100, 700, 0, dict(in_place=True)),
    ("headline flush: no frames, slide parked", 1024, 2, 8932, 0, 16, 8908, {}),
    ("headline chunk to the capacity's end", 1024, 2, 8932, 8916, 16, 8900, {}),
    ("headline 8915 frames: n*C no multiple of 8", 1024, 2, 8932, 8915, 12, 8912, {}),
    ("headline chunk 4 bytes past alignment", 1024, 2, 8932, 8916, 12, 8912,
     dict(chunk_offset=2)),
    ("headline chunk 2 bytes past alignment", 1024, 2, 8932, 8916, 12, 8912,
     dict(chunk_offset=1)),
    ("strided farm 1024 x 2, 16384 frames", 1024, 2, 16416, 16384, 16, 16380, {}),
    ("mixed group 256 x 2, 8192 frames, radius-17 reserve", 256, 2, 8266, 8192, 40, 8188, {}),
    ("wide farm 256 x 2, 44100 frames", 256, 2, 48116, 44100, 2010, 44098, {}),
    ("shard 1 of 4 on a side stream, 256 x 2", 256, 2, 8932, 8916, 12, 8912, dict(shard=1)),
    ("2048 mono streams", 2048, 1, 1200, 1000, 9, 1100, {}),
    ("7 streams x 6 channels", 7, 6, 300, 200, 37, 55, {}),
    ("3 streams x 200 channels", 3, 200, 300, 200, 37, 55, {}),
    *((f"{b} x {c}", b, c, 300, 200, 37, 55, {}) for b, c in FARM_SHAPES),
    *((f"{b} x {c} in place, 1 frame", b, c, 300, 1, 0, 0, dict(in_place=True))
      for b, c in ((1, 1), (6, 3), (64, 16))),
)
# farm_unstage_kernel against its plain version: (label, streams, channels,
# n_out, dtype, options). The source has 3 rows past n_out (a last launch's
# padding). Options: streams (lo, hi): a stream range; shard: that range on
# a side CUDA stream; pinned: into pinned host memory instead of the card's.
FARM_UNSTAGE_CASES = (
    ("headline 1024 x 2 x 8192 int32", 1024, 2, 8192, torch.int32, {}),
    ("headline 8191 frames int32", 1024, 2, 8191, torch.int32, {}),
    ("headline 8193 frames int16", 1024, 2, 8193, torch.int16, {}),
    ("headline int32 into pinned memory", 1024, 2, 8192, torch.int32, dict(pinned=True)),
    ("headline int16 into pinned memory", 1024, 2, 8191, torch.int16, dict(pinned=True)),
    ("shard 1 of 4: streams 256-512 on a side stream", 1024, 2, 8192, torch.int32,
     dict(streams=(256, 512), shard=1)),
    ("streams 341-768 int16, 8191 frames", 1024, 2, 8191, torch.int16, dict(streams=(341, 768))),
    ("wide farm 256 x 2 x 132", 256, 2, 132, torch.int32, {}),
    ("2048 mono streams int16", 2048, 1, 1001, torch.int16, {}),
    ("7 streams x 6 channels", 7, 6, 200, torch.int32, dict(streams=(2, 6))),
    ("3 streams x 200 channels int16", 3, 200, 77, torch.int16, {}),
    *((f"{b} x {c} {str(t)[6:]}", b, c, 37, t, {}) for b, c in FARM_SHAPES
      for t in (torch.int32, torch.int16)),
)
# General-class ratios at taps 184, 248, 272, 312, 352 and 1016, and 2008:
# the general entry against the wide entry across their crossover.
CROSSOVER_RATES = ((44100, 1500), (44100, 1100), (44100, 1000), (44100, 850), (44100, 760),
                   (44100, 262), (44100, 132))
# Config 7 (benchmarks/run_all.py:489-554): the whole-stream scan, 1024
# stereo streams (2048 lanes) at 44.1 kHz -> 8 kHz in chunks of 8192 frames
# (the general kernel each step); K random chunks and one zero chunk (the
# flush). The oracle scan checks lanes 0-3 and the last four; a CPU
# LowLevelResampler replays streams 0 and 1023. Timing: the per-chunk slope
# between K = 8 and K = 40.
SCAN7 = dict(rates=(44100, 8000), lanes=2048, n_in=8192, chunks=16, replay=(0, 1023),
             timing_k=(8, 40))
# The other engines at their fleet widths: tiled, strided, and a general
# ratio of 272 taps (the wide engine).
SCAN_ENGINES = (((48000, 44100), 2048), ((96000, 48000), 2048), ((44100, 1000), 512))
SCAN_ENGINE_CHUNKS = 4
# Checkpoints: the headline farm saved after 2 chunks and continued for 2
# more plus a flush; config 5 saved after its adjust_stream.
CKPT = dict(saved_after=2, continued=2, sampled=517)
# The sharded paths: SHARD_DP dp shards over the machine's cards in turn
# (shard_mesh); a kernel case with option ``shard`` = i runs as shard i's
# launch would, on a side CUDA stream over lanes [i*SHARD_LANES,
# (i+1)*SHARD_LANES) of a 2048-lane buffer. The sharded 44.1 kHz -> 132 Hz
# farm runs SHARDED_WIDE_CHUNKS chunks of WIDE_FARM's.
SHARD_DP = 4
SHARD_LANES = 512
SHARDED_WIDE_CHUNKS = 2
# sharded_resample_batch on a (dp, sp) mesh: 256 stereo streams over config
# 5's four ratios (MIXED["groups"]), 1024 input frames each under MIXED's
# radius-17 reserve (40 taps), 8192 output frames a stream split over sp.
# The quotas, dealt round: none, one ending inside the second sp shard, one
# inside the last (the 8 kHz -> 48 kHz streams reach 6145 frames), one
# inside the first, one on the first frame of the second, and zero.
BATCH = dict(streams=256, channels=2, n_in=1024, n_out=8192, mesh=(2, 4),
             quotas=(10**6, 3000, 6146, 500, 2049, 0))
# Config 5's fleet as one resample_batch call, the way a caller with every
# stream's chunk in hand makes it: 1024 stereo streams, 256 on each of
# MIXED's four ratios, 8192 input frames (config 5's chunk) under MIXED's
# radius-17 reserve (40 taps), 16,384 output frames (MAX_CHUNK_OUTPUT_FRAMES:
# the 8 kHz -> 48 kHz streams end output-full), BATCH's quotas dealt as
# there; unsharded (main path) and on a BATCH["mesh"] mesh (sharded paths).
FLEET = dict(BATCH, streams=1024, n_in=8192, n_out=16384, replay=(0, 1, 2, 3, 6, 517, 1022))
# batch_mac_kernel (resample_streams) against its plain version: (label,
# spec). Streams take spec["rates"], ["starts"] (p0, f0), ["quotas"] and
# ["totals"] (default n_in) in turn; max_taps defaults to the widest
# stream's; two_d: one stream as a 2-D (S, C) call with ints and 0-dim
# leaves (as resample_scan makes it); view: every other stream of a taller
# buffer (a stride between streams that is not S x C); shard: issued on a
# side CUDA stream, as a mesh shard's launch is; pad: rows of x past n_in
# (default twice the widest radius; 0: the last frames' windows run past the
# buffer, whose rows the kernel clamps); offset: x starts that many frames
# into its allocation (off 16 bytes: the first window's granules would reach
# before x, so the kernel copies it another way).
MIXED4 = list(MIXED["groups"])
BATCH_CASES = (
    ("2-D C=1 48k->44.1k p0=3", dict(rates=[(48000, 44100)], streams=1, channels=1, n_in=1024,
                                     n_out=2048, two_d=True, starts=[(3, 0x1234)])),
    ("2-D C=2 8k->48k output-full", dict(rates=[(8000, 48000)], streams=1, channels=2,
                                         n_in=1024, n_out=4096, two_d=True)),
    ("2-D C=3 int32 44.1k->8k", dict(rates=[(44100, 8000)], streams=1, channels=3, n_in=2048,
                                     n_out=512, two_d=True, dtype="int32", starts=[(1, 7)])),
    ("2-D C=2048 44.1k->8k (an oracle-scan step)", dict(
        rates=[(44100, 8000)], streams=1, channels=2048, n_in=512, n_out=128, two_d=True,
        starts=[(17, 0x2345)])),
    ("2-D C=2048 int32 96k->48k quota 100", dict(
        rates=[(96000, 48000)], streams=1, channels=2048, n_in=512, n_out=256, two_d=True,
        dtype="int32", quotas=[100])),
    ("B=20 C=2 four classes + 44.1k->132 (2008 taps)", dict(
        rates=MIXED4 + [(44100, 132)], streams=20, channels=2, n_in=4096, n_out=1024,
        quotas=[10**6, 0, 300, 1000, 10**6, 1023, 10**6], starts=[(0, 0), (5, 0x8001), (2, 3)])),
    ("B=64 C=2 int32 quotas 0 and mid-tile", dict(
        rates=MIXED4, streams=64, channels=2, n_in=2048, n_out=4096, dtype="int32",
        quotas=[0, 300, 513, 10**6, 2049, 511])),
    ("B=12 C=3 a short exhausted stream", dict(
        rates=MIXED4 + [(44100, 8000)], streams=12, channels=3, n_in=1024, n_out=2048,
        totals=[1024, 1024, 20, 1024, 1000], starts=[(0, 0), (7, 65535)])),
    ("B=8 C=1 general and strided", dict(
        rates=[(44100, 8000), (96000, 48000), (48000, 8000), (44100, 1000)], streams=8,
        channels=1, n_in=2048, n_out=1024, quotas=[10**6, 37])),
    ("B=16 C=2 view of a taller buffer", dict(
        rates=MIXED4, streams=16, channels=2, n_in=1024, n_out=2048, view=True)),
    ("shard: B=32 C=2 on a side stream", dict(
        rates=MIXED4, streams=32, channels=2, n_in=1024, n_out=8192, shard=True,
        quotas=list(BATCH["quotas"]))),
    ("B=5 C=3 odd quotas: zero spans off 16 bytes", dict(
        rates=MIXED4, streams=5, channels=3, n_in=1024, n_out=1001,
        quotas=[37, 1001, 5, 0, 999], starts=[(2, 0x1111)])),
    ("B=3 C=1 int16 odd n_out, produced n_out and 0", dict(
        rates=[(8000, 48000), (96000, 48000), (44100, 48000)], streams=3, channels=1,
        n_in=777, n_out=2047, quotas=[10**6, 0, 1500])),
    ("B=3 C=2048 int16 channel tiles, 16-byte rows", dict(
        rates=[(44100, 8000), (48000, 44100), (96000, 48000)], streams=3, channels=2048,
        n_in=256, n_out=96, quotas=[10**6, 0, 33])),
    ("B=2 C=100 int16 channel tiles, rows of whole words", dict(
        rates=[(44100, 8000), (8000, 48000)], streams=2, channels=100, n_in=512, n_out=256,
        quotas=[10**6, 77])),
    ("B=2 C=99 int16 channel tiles, rows off 16 bytes", dict(
        rates=[(48000, 44100), (44100, 8000)], streams=2, channels=99, n_in=512, n_out=256,
        quotas=[10**6, 41])),
    ("2-D C=72 int32 channel tiles of 64 and 8", dict(
        rates=[(8000, 48000)], streams=1, channels=72, n_in=128, n_out=512, two_d=True,
        dtype="int32", starts=[(0, 0x7777)])),
    ("B=4 C=2 int16 unpadded: clamped rows as words", dict(
        rates=MIXED4, streams=4, channels=2, n_in=1000, n_out=2048, pad=0)),
    ("B=3 C=3 int16 unpadded: clamped rows by element", dict(
        rates=[(44100, 8000), (96000, 48000), (48000, 44100)], streams=3, channels=3, n_in=999,
        n_out=1024, pad=0)),
    ("B=4 C=6 int16 flat quads", dict(
        rates=MIXED4, streams=4, channels=6, n_in=1024, n_out=1024, quotas=[10**6, 333])),
    ("B=2 C=4 int32 44.1k->132 (2008 taps): x read directly", dict(
        rates=[(44100, 132), (48000, 44100)], streams=2, channels=4, n_in=4096, n_out=64,
        dtype="int32")),
    ("B=3 C=2 int16 one frame into its buffer: granules kept inside x", dict(
        rates=[(8000, 48000), (48000, 44100), (44100, 8000)], streams=3, channels=2, n_in=1024,
        n_out=2048, offset=1)),
)
# The paths of batch_mac_kernel (batch_case_paths) that BATCH_CASES must take.
BATCH_PATHS = frozenset((
    "copy granules, flat", "copy granules, channel tiles", "copy words, channel tiles",
    "copy elements, channel tiles", "clamped rows as words", "clamped rows by element",
    "zero head off 16 bytes", "produced = n_out", "produced = 0", "2-D, C 2048 over frames",
    "a thread a frame", "geometry in shared memory", "x read directly",
    "flat granules past x's ends refused"))
CLI_RATES = (44100, 8000)   # the golden 470b79...: the fixture PCM is 44.1 kHz stereo
DEVICE = "cuda"
# The card's peaks for the bounds (NVIDIA's H100 SXM data sheet): HBM bytes/s, and int32 lanes per SM per clock on the CUDA cores
# (the per-term truncation keeps the taps off the tensor cores), times the
# SM count and the max SM clock that nvidia-smi reports.
HBM_BYTES_PER_S = 3.35e12
INT32_LANES_PER_SM = 64
# Integer instructions of one tap for one lane (mac_common.cuh macc_trunc):
# multiply, sign shift, bias multiply-add, shift-add.
OPS_PER_TAP = 4
CSRC = "clownresampler_tpu_torch/ops/csrc/"
PALLAS = "clownresampler_tpu/ops/pallas_resample.py"
KERNELS = {  # name -> (ROUTES kind, source, TPU kernels it replaces)
    "tiled_mac_kernel": ("tiled", CSRC + "resample_kernels.cu", f"{PALLAS}:201, {PALLAS}:61"),
    # The general entry launches tiled_mac_kernel too.
    "tiled_mac_kernel/general": ("general", CSRC + "resample_kernels.cu",
                                 f"{PALLAS}:475, {PALLAS}:61"),
    # Its scan mode: a tiled or general scan step, the window read from the
    # chunks in place, with the stage and bookkeeping XLA compiles into the
    # jitted scan around the engine.
    "tiled_mac_kernel/scan": ("scan_inplace", CSRC + "resample_kernels.cu",
                              f"{PALLAS}:475, {PALLAS}:201, clownresampler_tpu/lowlevel.py:378"),
    "strided_mac_kernel": ("strided", CSRC + "strided_kernels.cu",
                           f"{PALLAS}:664, {PALLAS}:720"),
    # Its scan mode: a strided scan step, likewise.
    "strided_mac_kernel/scan": ("scan_strided", CSRC + "strided_kernels.cu",
                                f"{PALLAS}:664, {PALLAS}:720, clownresampler_tpu/lowlevel.py:378"),
    "wide_mac_kernel": ("wide", CSRC + "wide_kernels.cu", f"{PALLAS}:1074, {PALLAS}:1158"),
    # Its scan mode with its fold: a launch of a wide scan step, likewise.
    "wide_mac_kernel/scan": ("scan_wide", CSRC + "wide_kernels.cu",
                             f"{PALLAS}:1074, {PALLAS}:1158, clownresampler_tpu/lowlevel.py:378"),
    # No Pallas kernels either: the farm's jitted staging programs and the
    # host's de-interleave of the launched lanes.
    "farm_stage_kernel": ("farm_stage", CSRC + "farm_kernels.cu",
                          "clownresampler_tpu/farm.py:274, clownresampler_tpu/farm.py:288, "
                          "clownresampler_tpu/farm.py:298"),
    "farm_unstage_kernel": ("farm_unstage", CSRC + "farm_kernels.cu",
                            "clownresampler_tpu/farm.py:517"),
    # No Pallas kernel: the chunk call XLA compiles under jax.vmap and shard_map
    # (resample_chunk and its gather convolve_frames).
    "batch_mac_kernel": ("batch", CSRC + "batch_kernels.cu",
                         "clownresampler_tpu/lowlevel.py:94, "
                         "clownresampler_tpu/ops/convolve.py:80"),
}
# The kernels the sharded paths launch (they run no scan).
SHARDED_KERNELS = tuple(name for name in KERNELS if not name.endswith("/scan"))


def phase(name: str, **fields) -> None:
    print(json.dumps({"phase": name, **fields}), flush=True)


def launch_case(in_rate, out_rate, lanes, n_out, gen, p0=0, f0=0, max_taps=None):
    """A launch's inputs on the card: x sized so every real frame's window
    fits; max_taps defaults to the ratio's width."""
    from clownresampler_tpu_torch import fixedpoint as fx
    from clownresampler_tpu_torch.configure import configure
    from clownresampler_tpu_torch.lowlevel import make_device_state
    from clownresampler_tpu_torch.models import DEFAULT_MODEL, table_tensor
    from clownresampler_tpu_torch.ops.resample import plan_uniform

    dev = torch.device(DEVICE)
    cfg = configure(in_rate, out_rate, max(in_rate, out_rate))
    inc = fx.calculate_ratio(in_rate, out_rate)
    taps = max_taps or fx.round_up(2 * cfg.integer_stretched_kernel_radius, 8)
    s = p0 + ((f0 + n_out * inc) >> 16) + 2 * cfg.integer_stretched_kernel_radius + taps + 16
    x = torch.randint(-32768, 32768, (s, lanes), generator=gen, dtype=torch.int32,
                      device=dev)
    return dict(
        table=table_tensor(DEFAULT_MODEL.table(), dev), x=x,
        state=make_device_state(p0, f0, cfg, inc, dev), max_taps=taps, n_out=n_out,
        plan=plan_uniform(inc, n_out), d=inc >> 16,
        table_strided=table_tensor(DEFAULT_MODEL.strided_table(cfg.kernel_step_size, taps), dev),
    )


def cuda_ms(fn, reps: int = 20) -> float:
    """Mean device time of fn() over `reps` back-to-back calls, by CUDA events.
    Every timed output is kept and checked equal to the first, so each
    launch's result is consumed; an untimed pass of `reps` kept calls first
    warms up and leaves the caching allocator holding the blocks the timed
    pass reuses, so no device allocation lands in the timed window."""
    first = fn()
    warm = [fn() for _ in range(reps)]
    del warm
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    outs = []
    start.record()
    for _ in range(reps):
        outs.append(fn())
    end.record()
    torch.cuda.synchronize()
    for o in outs:
        if not torch.equal(o, first):
            raise AssertionError("repeated launches disagree")
    return start.elapsed_time(end) / reps


@contextlib.contextmanager
def shard_stream(case):
    """Issue the body on a side CUDA stream when the case has the ``shard``
    option (as a mesh shard's launch is), ordered after the current stream's
    work and before what the current stream does next."""
    if "shard" not in case[4]:
        yield
        return
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        yield
    torch.cuda.current_stream().wait_stream(side)


def _shard_lanes(o: dict) -> None:
    """Turn a case's ``shard`` option into its lane slice."""
    if "shard" in o:
        o.update(lanes=SHARD_LANES, lane_offset=SHARD_LANES * o.pop("shard"))


def _valid_tensor(o: dict) -> None:
    """Turn a case's ``n_valid`` option into the entry's device tensor."""
    if "n_valid" in o:
        o["n_valid"] = torch.tensor([o["n_valid"]], dtype=torch.int32, device=DEVICE)


def _lanes_case(case, gen, kind: str) -> tuple:
    """(launch_case dict, x, state, the entry's arguments) of a TILED_CASES
    or GENERAL_CASES entry on the card."""
    from clownresampler_tpu_torch.lowlevel import DeviceState

    label, (a, b), n_out, lanes, opts = case
    o = dict(opts)
    _shard_lanes(o)
    c = launch_case(a, b, lanes, n_out, gen, p0=o.pop("p0", 0), f0=o.pop("f0", 0),
                    max_taps=o.pop("max_taps", None))
    if c["plan"]["kernel"] != kind:
        raise AssertionError(f"{label} is not a {kind} launch")
    x = c["x"][: c["x"].shape[0] - o.pop("cut", 0)]
    state = c["state"]
    if o.pop("ints", False):
        state = DeviceState(int(state.position_integer), int(state.position_fractional),
                            state.cfg)
    _valid_tensor(o)
    args = dict(max_taps=c["max_taps"], n_out=n_out,
                table_strided=None if o.pop("flat", False) else c["table_strided"])
    if kind == "tiled":
        args.update(d=o.pop("d", c["plan"]["d"]), cand=o.pop("cand", c["plan"]["cand"]))
    return c, x, state, dict(args, **o)


def run_tiled_case(case, gen) -> tuple:
    """(got, want, rows, rows_ref): one TILED_CASES launch through the tiled
    entry (the kernel) and its plain version, on the same inputs on the card."""
    from clownresampler_tpu_torch.ops import resample as rs

    c, x, state, args = _lanes_case(case, gen, "tiled")
    with shard_stream(case):
        got, rows = rs.resample_uniform_lanes_tiled(c["table"], x, state, **args)
    want, rows_ref = rs.resample_uniform_lanes_tiled_reference(c["table"], x, state, **args)
    return got, want, rows, rows_ref


def run_general_case(case, gen) -> tuple:
    """(got, want, rows, rows_ref): one GENERAL_CASES launch through the
    general entry (the kernel) and its plain version, on the same inputs."""
    from clownresampler_tpu_torch.ops import resample as rs

    c, x, state, args = _lanes_case(case, gen, "general")
    with shard_stream(case):
        got, rows = rs.resample_uniform_lanes_general(c["table"], x, state, **args)
    want, rows_ref = rs.resample_uniform_lanes_general_reference(c["table"], x, state, **args)
    return got, want, rows, rows_ref


def _case_launch(case, gen, kind: str) -> tuple:
    """(launch_case dict, x, state, the entry's arguments) of a STRIDED_CASES
    or WIDE_CASES entry on the card."""
    from clownresampler_tpu_torch.lowlevel import DeviceState

    label, (a, b), n_out, lanes, opts = case
    o = dict(opts)
    _shard_lanes(o)
    c = launch_case(a, b, lanes, n_out, gen, p0=o.pop("p0", 0), f0=o.pop("f0", 0),
                    max_taps=o.pop("max_taps", None))
    if kind == "strided" and c["plan"]["kernel"] != "strided":
        raise AssertionError(f"{label} is not a strided launch")
    cut = o.pop("cut", 0)
    if kind == "strided":
        cut *= c["d"]
    elif cut:       # wide: rows for `cut` frames (True: 8), and 8 more
        cut = (8 if cut is True else cut) * c["d"] + 8
    x = c["x"][: c["x"].shape[0] - cut]
    state = c["state"]
    if o.pop("ints", False):
        state = DeviceState(int(state.position_integer), int(state.position_fractional),
                            state.cfg)
    _valid_tensor(o)
    args = dict(max_taps=c["max_taps"], n_out=n_out, d=c["d"], **o)
    if kind == "wide":
        args["table_strided"] = None if args.pop("flat", False) else c["table_strided"]
    return c, x, state, args


def run_strided_case(case, gen) -> tuple:
    """(got, want, rows, rows_ref): one STRIDED_CASES launch through the
    strided entry (the kernel) and its plain version, on the same inputs."""
    from clownresampler_tpu_torch.ops import resample as rs

    c, x, state, args = _case_launch(case, gen, "strided")
    with shard_stream(case):
        got, rows = rs.resample_strided_phases(c["table"], x, state, **args)
    want, rows_ref = rs.resample_strided_reference(c["table"], x, state, **args)
    return got, want, rows, rows_ref


def run_wide_case(case, gen) -> tuple:
    """(got, want, rows, rows_ref): one WIDE_CASES launch through the wide
    entry (the kernels) and its plain version, on the same inputs (option
    frames: the kernels' N, the plain version's frames sliced to it)."""
    from clownresampler_tpu_torch.ops import resample as rs

    c, x, state, args = _case_launch(case, gen, "wide")
    frames = args.pop("frames", args["n_out"])
    with shard_stream(case):
        got, rows = rs.resample_wide_taps(c["table"], x, state, **dict(args, n_out=frames))
    want, rows_ref = rs.resample_wide_taps_reference(c["table"], x, state, **args)
    return got, want[:frames], rows, rows_ref[:frames]


def scan_inplace_inputs(rates, lanes: int, n_in: int, dtype, gen, chunks=3, p=0, f=0,
                        n_out=None, offset=0, flat=False, taps=None) -> dict:
    """One scan step's inputs on the card: ``chunks`` random chunks of the
    given type as one contiguous tensor starting ``offset`` elements past a
    16-byte aligned address, the state (p + radius, f) and the scan's
    geometry, as scan_case sizes it (``taps`` a reserve other than the
    radius's)."""
    from clownresampler_tpu_torch import fixedpoint as fx
    from clownresampler_tpu_torch.configure import configure
    from clownresampler_tpu_torch.lowlevel import make_device_state
    from clownresampler_tpu_torch.models import DEFAULT_MODEL, table_tensor

    dev = torch.device(DEVICE)
    cfg = configure(*rates, max(rates))
    inc = fx.calculate_ratio(*rates)
    r = cfg.integer_stretched_kernel_radius
    taps = taps or fx.round_up(2 * r, 8)
    count = chunks * n_in * lanes
    flat_buf = torch.randint(-32768, 32768, (count + 8,), generator=gen, dtype=torch.int32,
                             device=dev).to(dtype)
    return dict(
        chunks=flat_buf[offset : offset + count].view(chunks, n_in, lanes),
        state=torch.tensor([p + r, f], dtype=torch.int32).to(dev),
        cfg=make_device_state(0, 0, cfg, inc, dev).cfg,
        table=table_tensor(DEFAULT_MODEL.table(), dev),
        args=dict(radius=r, max_taps=taps, increment=inc,
                  n_out=n_out or fx.round_up((((n_in + 2 * r) << 16) // inc) + 8, 128),
                  table_strided=None if flat else table_tensor(
                      DEFAULT_MODEL.strided_table(cfg.kernel_step_size, taps), dev)))


@contextlib.contextmanager
def wide_launch_frames(frames):
    """The wide engine's frames a launch set to ``frames`` (None: as
    ops.resample.wide_launch_frames gives them) for the body: a case's
    several launches a step."""
    from clownresampler_tpu_torch import lowlevel

    if frames is None:
        yield
        return
    saved = lowlevel.wide_launch_frames
    lowlevel.wide_launch_frames = lambda taps: frames
    try:
        yield
    finally:
        lowlevel.wide_launch_frames = saved


def run_scan_mode_case(case, gen) -> tuple:
    """One case of a SCAN_MODE_CASES table through scan_inplace_step (the
    engine's scan-mode launches of one step) against
    scan_inplace_step_reference on the same inputs: the step's frames,
    produced, over and the next state, exact. Returns the largest difference
    (0) and the paths the launches took: the copy path with the chunk type,
    and for the strided engine whether the windows are read from the stream
    (no stage holds them), for the wide one whether the step is several
    launches."""
    from clownresampler_tpu_torch import lowlevel
    from clownresampler_tpu_torch.ops import _build
    from clownresampler_tpu_torch.ops.resample import strided_stage_plan

    label, rates, lanes, n_in, dtype, k, opts = case
    o = dict(opts)
    launch_frames = o.pop("launch_frames", None)
    c = scan_inplace_inputs(rates, lanes, n_in, dtype, gen, **o)
    inputs = (c["table"], c["chunks"], k, c["state"], c["cfg"])
    a = c["args"]
    with wide_launch_frames(launch_frames):
        kind, d, _, step = lowlevel._scan_engine(a["increment"], a["max_taps"], a["n_out"])
        got = lowlevel.scan_inplace_step(*inputs, **a)
        want = lowlevel.scan_inplace_step_reference(*inputs, **a)
    err = 0
    for name, g, w in zip(("frames", "produced", "over", "next_state"), got, want):
        if g.dtype != w.dtype or g.shape != w.shape or not torch.equal(g, w):
            raise AssertionError(f"the {kind} engine's scan mode != plain version at {label}: "
                                 f"{name}")
        err = max(err, int((g.long() - w.long()).abs().max()))
    elem = c["chunks"].element_size()
    copy = _build.scan_copy_path(elem_bytes=elem, lanes=lanes, ptr=c["chunks"].data_ptr())
    paths = {f"{str(dtype)[6:]} {SCAN_COPY_NAMES[copy]}"}
    if kind == "strided" and strided_stage_plan(d, a["max_taps"], elem)[1] == 0:
        paths.add("windows read from the stream")
    if kind == "wide" and step < a["n_out"]:
        paths.add("several launches a step")
    return err, paths


def run_farm_stage_case(case, gen) -> tuple:
    """One FARM_STAGE_CASES launch of farm_stage_kernel against
    farm_stage_reference on the same inputs: the whole destination buffer,
    exact, and the source untouched. Returns the largest difference (0) and
    the path the launch took."""
    from clownresampler_tpu_torch.farm import farm_stage, farm_stage_reference
    from clownresampler_tpu_torch.ops import _build

    label, b, c, capacity, n, keep, consumed, opts = case
    dev = torch.device(DEVICE)
    rand = lambda *shape: torch.randint(-32768, 32768, shape, generator=gen, dtype=torch.int32,
                                        device=dev)
    src = rand(capacity, b * c)
    dst = src if opts.get("in_place") else rand(capacity, b * c)
    if "shard" in opts:
        chunk = rand(SHARD_DP * b, n, c).to(torch.int16)[opts["shard"] * b :][:b]
    else:
        off = opts.get("chunk_offset", 0)
        chunk = rand(b * n * c + off).to(torch.int16)[off:].view(b, n, c)
    want_src = src.clone()
    want = want_src if opts.get("in_place") else dst.clone()
    farm_stage_reference(want_src, want, chunk, keep=keep, consumed=consumed)
    path = _build.farm_stage_args(src, dst, chunk, streams=b, channels=c, n_in=n, keep=keep,
                                  consumed=consumed)["path"]
    with shard_stream((None,) * 4 + (opts,)):
        farm_stage(src, dst, chunk, keep=keep, consumed=consumed)
    if not (torch.equal(dst, want) and torch.equal(src, want_src)):
        raise AssertionError(f"farm_stage_kernel != plain version at {label}")
    return int((dst.long() - want.long()).abs().max()), path


def run_farm_unstage_case(case, gen) -> int:
    """One FARM_UNSTAGE_CASES launch of farm_unstage_kernel against
    farm_unstage_reference, exact; what lies past the destination's
    (streams, n_out, channels) elements stays untouched."""
    from clownresampler_tpu_torch.farm import farm_unstage, farm_unstage_reference

    label, b, c, n_out, dtype, opts = case
    dev = torch.device(DEVICE)
    lanes = torch.randint(-32768, 32768, (n_out + 3, b * c), generator=gen, dtype=torch.int32,
                          device=dev).to(dtype)
    lo, hi = opts.get("streams", (0, b))
    want = farm_unstage_reference(lanes, n_out, c, lo, hi - lo)
    out = torch.full((want.numel() + 8,), -7, dtype=dtype, device=dev)
    if opts.get("pinned"):
        out = out.cpu().pin_memory()
    with shard_stream((None,) * 4 + (opts,)):
        got = farm_unstage(lanes, n_out, c, lo, hi - lo, out=out)
    torch.cuda.synchronize()
    if not (got.dtype == dtype and got.shape == want.shape
            and torch.equal(got.to(dev), want) and (out[want.numel():] == -7).all()):
        raise AssertionError(f"farm_unstage_kernel != plain version at {label}")
    return int((got.to(dev).long() - want.long()).abs().max())


def batch_case_inputs(spec: dict, gen) -> tuple:
    """(table, x, totals, state, quota, kw) of a BATCH_CASES entry on the
    card: random samples in every row (exactness needs no zero padding),
    the per-stream leaves as device tensors (ints and 0-dim leaves for a
    2-D call)."""
    from clownresampler_tpu_torch import fixedpoint as fx
    from clownresampler_tpu_torch.batch import stack_states
    from clownresampler_tpu_torch.configure import configure
    from clownresampler_tpu_torch.lowlevel import make_device_state
    from clownresampler_tpu_torch.models import DEFAULT_MODEL, table_tensor

    dev = torch.device(DEVICE)
    b, c, view = spec["streams"], spec["channels"], spec.get("view", False)
    turn = lambda key, default: [spec.get(key, default)[i % len(spec.get(key, default))]
                                 for i in range(b)]
    cfgs = [(configure(a, o, max(a, o)), fx.calculate_ratio(a, o))
            for a, o in turn("rates", None)]
    r_max = max(cfg.integer_stretched_kernel_radius for cfg, _ in cfgs)
    taps = spec.get("max_taps") or fx.round_up(2 * r_max, 8)
    s = spec["n_in"] + spec.get("pad", 2 * r_max)
    x = torch.randint(-32768, 32768, ((2 if view else 1) * b, s + (5 if view else 0), c),
                      generator=gen, dtype=getattr(torch, spec.get("dtype", "int16")),
                      device=dev)
    if view:
        x = x[::2, 3 : 3 + s]
    if spec.get("offset"):
        x = torch.cat([x.new_zeros(spec["offset"] * c), x.reshape(-1)])[spec["offset"] * c :]
        x = x.view(b, s, c)
    states = [make_device_state(p0, f0, cfg, inc, dev)
              for (cfg, inc), (p0, f0) in zip(cfgs, turn("starts", [(0, 0)]))]
    totals, quotas = turn("totals", [spec["n_in"]]), turn("quotas", [10**6])
    kw = dict(max_taps=taps, n_out=spec["n_out"])
    table = table_tensor(DEFAULT_MODEL.table(), dev)
    if spec.get("two_d"):
        return table, x[0], totals[0], states[0], quotas[0], kw
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)
    return table, x, i32(totals), stack_states(states), i32(quotas), kw


def _edge_windows(p0: int, f0: int, cfg: dict, i: int, tl: int, plan: dict, produced: int,
                  elem_bytes: int, by_thread: bool) -> tuple:
    """The input rows [first, end) of stream i's first stage's window (frame 0
    on) and of the stage that holds its last produced frame
    (batch_kernels.cu stage_window)."""
    from clownresampler_tpu_torch.ops import _build

    inc = (cfg["increment_hi"][i] << 16) + cfg["increment_lo"][i]
    delta = cfg["stretched_kernel_radius_delta"][i]

    def row(n: int) -> int:
        t = f0 + n * inc
        return p0 + (t >> 16) + (((t & 0xFFFF) + delta + 0xFFFF) >> 16)

    def stage_frames(n0: int, live_end: int) -> int:
        return _build.batch_stage_frames(increment=inc, tap_stride=tl,
                                         channels=plan["channel_tile"], frames=live_end - n0,
                                         elem_bytes=elem_bytes, by_thread=by_thread)[0]

    nr = plan["range_frames"]
    first_end = min(produced, nr)
    n0 = (produced - 1) // nr * nr
    f = stage_frames(n0, produced)
    a = n0 + (produced - 1 - n0) // f * f
    return ((row(0), row(min(stage_frames(0, first_end), first_end) - 1) + tl),
            (row(a), row(produced - 1) + tl))


def _granules_inside_x(xb, i: int, first: int, end: int) -> bool:
    """Whether the 16-byte granules that cover rows [first, end) of stream i
    of ``xb`` lie inside its B streams (batch_kernels.cu granules_inside_x)."""
    b, s, c = xb.shape
    es, x0 = xb.element_size(), xb.data_ptr()
    x1 = x0 + ((b - 1) * xb.stride(0) + s * c) * es
    at = lambda r: x0 + (i * xb.stride(0) + r * c) * es
    return at(first) & ~15 >= x0 and (at(end) + 15) & ~15 <= x1


def batch_case_paths(x, state, produced, *, max_taps: int, n_out: int) -> set:
    """The BATCH_PATHS a batch_mac_kernel launch on ``x`` ((S, C) or (B, S,
    C)) from ``state`` took, from its plan (ops/_build.py batch_plan,
    batch_copy_path, batch_stage_frames) and the streams' produced counts."""
    from clownresampler_tpu_torch.ops import _build

    xb = x[None] if x.dim() == 2 else x
    b, _, c = xb.shape
    plan = _build.batch_plan(b, n_out, c)
    copy = _build.batch_copy_path(channels=c, elem_bytes=xb.element_size(),
                                  stride_b=xb.stride(0), ptr=xb.data_ptr())
    produced = [int(v) for v in produced.reshape(-1).cpu()]
    cfg = {f: [int(v) for v in getattr(state.cfg, f).reshape(-1).expand(b).cpu()]
           for f in ("increment_hi", "increment_lo", "integer_stretched_kernel_radius",
                     "stretched_kernel_radius", "stretched_kernel_radius_delta")}
    flat = plan["channel_tile"] == c
    paths = set()
    if any(produced):
        paths.add("copy granules, flat" if flat else
                  "copy granules, channel tiles" if copy & _build.BATCH_COPY_VEC else
                  "copy words, channel tiles" if copy & _build.BATCH_COPY_WORDS else
                  "copy elements, channel tiles")
    p0 = [int(v) for v in state.position_integer.reshape(-1).expand(b).cpu()]
    f0 = [int(v) for v in state.position_fractional.reshape(-1).expand(b).cpu()]
    for i, p in enumerate(produced):
        # The zero span of the block that holds frame p starts at output int
        # (i * n_out + p) * C.
        if flat and 0 <= p < n_out and (i * n_out + p) * c % 4:
            paths.add("zero head off 16 bytes")
        if p > 0:
            tl = _build.batch_tap_stride(
                int_radius=cfg["integer_stretched_kernel_radius"][i],
                radius=cfg["stretched_kernel_radius"][i],
                delta=cfg["stretched_kernel_radius_delta"][i], max_taps=max_taps)
            frames, _ = _build.batch_stage_frames(
                increment=(cfg["increment_hi"][i] << 16) + cfg["increment_lo"][i],
                tap_stride=tl, channels=plan["channel_tile"],
                frames=min(p, plan["range_frames"]), elem_bytes=xb.element_size(),
                by_thread=flat and c <= 4)
            paths.add("x read directly" if not frames else
                      "a thread a frame" if flat and c <= 4 else "geometry in shared memory")
            windows = _edge_windows(p0[i], f0[i], cfg, i, tl, plan, p, xb.element_size(),
                                    flat and c <= 4) if frames else ()
            for first, end in windows:
                if first < 0 or end > xb.shape[1]:
                    paths.add("clamped rows as words" if copy & _build.BATCH_COPY_WORDS else
                              "clamped rows by element")
                elif flat and not _granules_inside_x(xb, i, first, end):
                    paths.add("flat granules past x's ends refused")
    paths |= {"produced = n_out"} if n_out in produced else set()
    paths |= {"produced = 0"} if 0 in produced else set()
    if x.dim() == 2 and c == 2048 and plan["range_frames"] < n_out:
        paths.add("2-D, C 2048 over frames")
    return paths


def run_batch_case(case, gen, paths=None) -> int:
    """One BATCH_CASES launch of batch_mac_kernel (resample_streams) against
    lowlevel.resample_chunk_reference on the same inputs: every leaf exact.
    Returns the output's max abs error (0); adds the launch's BATCH_PATHS to
    ``paths``."""
    from clownresampler_tpu_torch.lowlevel import resample_chunk_reference
    from clownresampler_tpu_torch.ops import resample as rs

    label, spec = case
    table, x, totals, state, quota, kw = batch_case_inputs(spec, gen)
    with shard_stream((None,) * 4 + (spec,)):
        got = rs.resample_streams(table, x, totals, state, quota, **kw)
    want = resample_chunk_reference(table, x, totals, state, quota, **kw)
    for i, (g, w) in enumerate(zip(_batch_leaves(got), _batch_leaves(want))):
        if g.shape != w.shape or g.dtype != w.dtype or not torch.equal(g, w):
            raise AssertionError(f"batch_mac_kernel != plain version at {label}, leaf {i}")
    if paths is not None:
        paths |= batch_case_paths(x, state, got[1], **kw)
    return int((got[0].long() - want[0].long()).abs().max())


def _compare(results, kernel, name, got, want, rows=None, rows_ref=None):
    err = (got.long() - want.long()).abs().max().item()
    if err or got.dtype != want.dtype or got.shape != want.shape or (
            rows is not None and not torch.equal(rows, rows_ref)):
        raise AssertionError(f"{kernel} != plain version at {name}: max err {err}")
    results[kernel].append((name, err))


def check_kernels(gen) -> dict:
    """Each kernel against its plain version on the same inputs on the card,
    exact equality over every frame of the launch (padding frames included)."""
    results = {name: [] for name in KERNELS}
    for case in TILED_CASES:
        _compare(results, "tiled_mac_kernel", case[0], *run_tiled_case(case, gen))
    for case in GENERAL_CASES:
        _compare(results, "tiled_mac_kernel/general", case[0], *run_general_case(case, gen))
    for case in STRIDED_CASES:
        _compare(results, "strided_mac_kernel", case[0], *run_strided_case(case, gen))
    for case in WIDE_CASES:
        _compare(results, "wide_mac_kernel", case[0], *run_wide_case(case, gen))
    for kernel, cases, want in SCAN_MODE_CASES:
        scan_paths = set()
        for case in cases:
            err, paths = run_scan_mode_case(case, gen)
            results[kernel].append((case[0], err))
            scan_paths |= paths
        if scan_paths != want:
            raise AssertionError(f"{kernel}'s cases missed the paths "
                                 f"{sorted(want - scan_paths)}")
    paths = set()
    for case in FARM_STAGE_CASES:
        err, path = run_farm_stage_case(case, gen)
        results["farm_stage_kernel"].append((case[0], err))
        paths.add(path)
    if paths != {0, 1, 2}:
        raise AssertionError(f"FARM_STAGE_CASES took the paths {paths}, not all three")
    for case in FARM_UNSTAGE_CASES:
        results["farm_unstage_kernel"].append((case[0], run_farm_unstage_case(case, gen)))
    batch_paths = set()
    for case in BATCH_CASES:
        results["batch_mac_kernel"].append((case[0], run_batch_case(case, gen, batch_paths)))
    if batch_paths != BATCH_PATHS:
        raise AssertionError(f"BATCH_CASES missed the paths {sorted(BATCH_PATHS - batch_paths)}")
    torch.cuda.synchronize()
    return results


def card_peaks() -> dict:
    """HBM bytes/s and int32 operations/s of the card (HBM_BYTES_PER_S;
    SMs x INT32_LANES_PER_SM x the max SM clock)."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return dict(hbm_bytes_per_s=HBM_BYTES_PER_S, sms=sms, max_sm_clock_mhz=mhz,
                int32_ops_per_s=sms * INT32_LANES_PER_SM * mhz * 1e6)


def launch_bound(c, lanes: int, peaks: dict, rows_out: bool = False) -> dict:
    """The least time the card could take for launch c over ``lanes``
    lanes: the larger of its bytes -- the input rows its frames' windows
    reach, read once, and the int32 output (and the rows, for the tiled
    entry) written once -- over the HBM rate, and OPS_PER_TAP operations for
    each live tap (the taps this run's frames need, not the launch width) and
    lane over the int32 rate."""
    from clownresampler_tpu_torch import fixedpoint as fx
    from clownresampler_tpu_torch.ops.convolve import window_geometry

    st, n_out, taps = c["state"], c["n_out"], c["max_taps"]
    n = torch.arange(n_out, dtype=torch.int32, device=c["x"].device)
    pos, frac = fx.positions_from_state(st.position_integer, st.position_fractional,
                                        st.cfg.increment_hi, st.cfg.increment_lo, n)
    min_rel, _, _, live = window_geometry(st.cfg, frac)
    rows = (pos + min_rel).clamp(0, c["x"].shape[0] - taps)
    span = min(int(rows[-1] - rows[0]) + taps, c["x"].shape[0])
    nbytes = 4 * (span * lanes + n_out * lanes + (n_out if rows_out else 0))
    ops = OPS_PER_TAP * int(live.clamp(max=taps).sum()) * lanes
    memory_ms = 1e3 * nbytes / peaks["hbm_bytes_per_s"]
    ops_ms = 1e3 * ops / peaks["int32_ops_per_s"]
    return dict(bound_ms=max(memory_ms, ops_ms),
                bound_by="bytes" if memory_ms >= ops_ms else "operations",
                bytes=nbytes, int32_ops=ops, memory_ms=memory_ms, operations_ms=ops_ms)


def device_launches(fn) -> tuple:
    """(names of the device activities one fn() call runs, one per launch or
    copy; their device ms) by torch.profiler, after a warm-up call. A
    profiler run leaves every later launch from the host in the process
    about twice as slow (PERF.md), so the script profiles after its timings."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    names, us = [], 0.0
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            names += [evt.key] * evt.count
            us += evt.self_device_time_total
    return names, us / 1e3


def time_kernels(gen) -> dict:
    """Per-launch device times, with each launch's bound (launch_bound): the
    tiled, general, strided and wide entries, each its kernel launches alone
    (they compute their own geometry; count_entry_launches), against their
    plain entries, at the headline tiled launch, a 44.1k->8k general launch,
    the 96k->48k strided farm launch (and the same at a 40-tap reserve) and
    the 44.1k->132 wide launch; then the general entry against the wide
    entry from 184 to 2008 taps (CROSSOVER_RATES), and the wide entry's time
    per frame against its launch size."""
    from clownresampler_tpu_torch.ops import resample as rs

    from clownresampler_tpu_torch import fixedpoint as fx

    out = {}
    peaks = card_peaks()
    c = launch_case(*HEADLINE["rates"], HEADLINE["lanes"], HEADLINE["n_out"], gen)
    st = c["state"]
    d, cand = c["plan"]["d"], c["plan"]["cand"]
    lanes = c["x"].shape[1]
    args = dict(max_taps=c["max_taps"], n_out=c["n_out"], d=d, cand=cand,
                table_strided=c["table_strided"])
    out["tiled_mac_kernel"] = dict(
        ms=cuda_ms(lambda: rs.resample_uniform_lanes_tiled(c["table"], c["x"], st, **args)[0]),
        plain_ms=cuda_ms(lambda: rs.resample_uniform_lanes_tiled_reference(
            c["table"], c["x"], st, **args)[0]),
        stage=dict(zip(("frames", "window_rows"),
                       rs.stage_plan(c["max_taps"], rs.tiled_increment_bound(d, cand)))),
        **launch_bound(c, lanes, peaks, rows_out=True),
        shape=f"x ({c['x'].shape[0]}, {lanes}) int32, n_out {c['n_out']}, taps {c['max_taps']}",
    )
    g = launch_case(44100, 8000, 2048, 4096, gen)
    gargs = dict(max_taps=g["max_taps"], n_out=g["n_out"], table_strided=g["table_strided"])
    frames, win_rows = rs.stage_plan(g["max_taps"], rs.GENERAL_MIN_INCREMENT)
    out["tiled_mac_kernel/general"] = dict(
        ms=cuda_ms(lambda: rs.resample_uniform_lanes_general(
            g["table"], g["x"], g["state"], **gargs)[0]),
        plain_ms=cuda_ms(lambda: rs.resample_uniform_lanes_general_reference(
            g["table"], g["x"], g["state"], **gargs)[0]),
        stage=dict(most_frames=frames, window_rows=win_rows, frames=rs.stage_frames(
            fx.calculate_ratio(44100, 8000), frames, g["max_taps"], win_rows)),
        **launch_bound(g, 2048, peaks, rows_out=True),
        shape=f"x ({g['x'].shape[0]}, 2048) int32, n_out {g['n_out']}, taps {g['max_taps']}",
    )
    s = launch_case(*STRIDED_FARM["rates"], 2048, HEADLINE["n_out"], gen)
    sargs = dict(max_taps=s["max_taps"], n_out=s["n_out"], d=s["d"])
    strided_entry = lambda taps: (lambda: rs.resample_strided_phases(
        s["table"], s["x"], s["state"], **dict(sargs, max_taps=taps))[0])
    out["strided_mac_kernel"] = dict(
        ms=cuda_ms(strided_entry(s["max_taps"])),
        plain_ms=cuda_ms(lambda: rs.resample_strided_reference(
            s["table"], s["x"], s["state"], **sargs)[0]),
        reserve40_ms=cuda_ms(strided_entry(40)),
        stage=dict(zip(("frames", "window_rows"), rs.strided_stage_plan(s["d"], s["max_taps"]))),
        **launch_bound(s, 2048, peaks, rows_out=True),
        shape=f"x ({s['x'].shape[0]}, 2048) int32, n_out {s['n_out']}, d {s['d']}, "
              f"taps {s['max_taps']}",
    )
    k = out["strided_mac_kernel"]
    k["reserve40_over_reserve16"] = k["reserve40_ms"] / k["ms"]
    crossover = {}
    for rates in CROSSOVER_RATES:
        for n_out, lanes in ((64, 1024), (1024, 512)):
            w = launch_case(*rates, lanes, n_out, gen, f0=0x4321)
            wargs = dict(max_taps=w["max_taps"], n_out=n_out, d=w["d"],
                         table_strided=w["table_strided"])
            wide_fn = lambda: rs.resample_wide_taps(w["table"], w["x"], w["state"], **wargs)[0]
            general_fn = lambda: rs.resample_uniform_lanes_general(
                w["table"], w["x"], w["state"], max_taps=w["max_taps"], n_out=n_out,
                table_strided=w["table_strided"])[0]
            if not torch.equal(wide_fn(), general_fn()):
                raise AssertionError(f"wide and general entries disagree at {rates}")
            key = f"{rates[0]}->{rates[1]} taps {w['max_taps']}, {n_out} frames x {lanes} lanes"
            crossover[key] = dict(general_entry_ms=cuda_ms(general_fn),
                                  wide_entry_ms=cuda_ms(wide_fn))
            if (rates, n_out) == ((44100, 132), 64):
                out["wide_mac_kernel"] = dict(
                    ms=crossover[key]["wide_entry_ms"],
                    plain_ms=cuda_ms(lambda: rs.resample_wide_taps_reference(
                        w["table"], w["x"], w["state"], **wargs)[0], reps=5),
                    **launch_bound(w, lanes, peaks, rows_out=True),
                    shape=f"x ({w['x'].shape[0]}, {lanes}) int32, n_out {n_out}, "
                          f"taps {w['max_taps']}")
    launch_frames = {}
    for n_out in (64, 256, 1024, rs.wide_launch_frames(2008)):
        w = launch_case(44100, 132, 512, n_out, gen)
        wargs = dict(max_taps=w["max_taps"], n_out=n_out, d=w["d"],
                     table_strided=w["table_strided"])
        ms = cuda_ms(lambda: rs.resample_wide_taps(w["table"], w["x"], w["state"], **wargs)[0],
                     reps=5)
        launch_frames[n_out] = dict(entry_ms=ms, us_per_frame=1e3 * ms / n_out)
    for k in out.values():
        k["bound_share"] = k["bound_ms"] / k["ms"]
    return dict(peaks=peaks, kernels=out, general_vs_wide=crossover,
                wide_launch_frames_taps2008=launch_frames)


# Entry -> the kernels one call may run on the card, in launch order: the
# whole of the entry's device work (no precompute, no copy).
ENTRY_KERNELS = {"tiled": ("tiled_mac_kernel",), "general": ("tiled_mac_kernel",),
                 "strided": ("strided_mac_kernel",),
                 "wide": ("wide_mac_kernel", "wide_fold_kernel"),
                 "batch": ("batch_mac_kernel",)}


def count_entry_launches(gen) -> dict:
    """The device activities of one call of the tiled, general, strided and
    wide entries at their timed launches and of resample_batch at BATCH
    (torch.profiler): exactly their kernels (ENTRY_KERNELS), one for tiled,
    general, strided and batch, two for wide, and their device time. A
    count that is off is taken again (the profiler now and then loses a
    record), up to three times."""
    from clownresampler_tpu_torch.batch import resample_batch
    from clownresampler_tpu_torch.ops import resample as rs

    c = launch_case(*HEADLINE["rates"], HEADLINE["lanes"], HEADLINE["n_out"], gen)
    g = launch_case(44100, 8000, 2048, 4096, gen)
    s = launch_case(*STRIDED_FARM["rates"], 2048, HEADLINE["n_out"], gen)
    w = launch_case(44100, 132, 1024, 64, gen, f0=0x4321)
    b = batch_case(np.random.default_rng(SEED))
    calls = {
        "tiled": lambda: rs.resample_uniform_lanes_tiled(
            c["table"], c["x"], c["state"], max_taps=c["max_taps"], n_out=c["n_out"],
            d=c["plan"]["d"], cand=c["plan"]["cand"], table_strided=c["table_strided"]),
        "general": lambda: rs.resample_uniform_lanes_general(
            g["table"], g["x"], g["state"], max_taps=g["max_taps"], n_out=g["n_out"],
            table_strided=g["table_strided"]),
        "strided": lambda: rs.resample_strided_phases(
            s["table"], s["x"], s["state"], max_taps=s["max_taps"], n_out=s["n_out"], d=s["d"]),
        "wide": lambda: rs.resample_wide_taps(
            w["table"], w["x"], w["state"], max_taps=w["max_taps"], n_out=w["n_out"], d=w["d"],
            table_strided=w["table_strided"]),
        "batch": lambda: resample_batch(*b["args"], **b["kw"]),
    }
    res = {}
    for kind, fn in calls.items():
        want = ENTRY_KERNELS[kind]
        for attempt in range(1, 4):
            names, device_ms = device_launches(fn)
            if len(names) == len(want) and all(sum(k in n for n in names) == 1 for k in want):
                break
            if attempt == 3:
                raise AssertionError(f"one {kind} entry call ran {names} on the card in each of "
                                     f"3 profiles, not {want}")
        res[kind] = dict(device_activities=names, kernel_ms=device_ms, profiles_taken=attempt)
    return res


def run_goldens() -> list:
    """The reference's four golden conversions through resample_array, and two
    through HighLevelResampler.resample_stream (bulk, the CUDA default)."""
    import clownresampler_tpu_torch as crt
    from clownresampler_tpu_torch.utils.audio_io import read_raw_s16le

    pcm = read_raw_s16le(PCM, channels=2)
    md5 = lambda a: hashlib.md5(np.asarray(a, dtype="<i4").tobytes()).hexdigest()
    done = []
    for in_rate, out_rate, lpf, want in GOLDENS:
        got = md5(crt.resample_array(pcm, in_rate, out_rate, lpf, device="cuda"))
        if got != want:
            raise AssertionError(f"resample_array {in_rate}->{out_rate} lpf {lpf}: md5 {got}")
        done.append(f"resample_array {in_rate}->{out_rate} lpf {lpf}")
    for in_rate, out_rate, lpf, want in GOLDENS[::2]:
        cursor = 0

        def feed(total: int) -> np.ndarray:
            nonlocal cursor
            got = pcm[cursor : cursor + total]
            cursor += got.shape[0]
            return got

        hl = crt.HighLevelResampler.init(2, in_rate, out_rate, lpf, device="cuda")
        got = md5(hl.resample_stream(feed))
        if got != want:
            raise AssertionError(f"resample_stream {in_rate}->{out_rate}: md5 {got}")
        done.append(f"resample_stream {in_rate}->{out_rate} lpf {lpf}")
    return done


def oracle_stream(data: np.ndarray, in_rate: int, out_rate: int) -> np.ndarray:
    """One stream through the port's gather oracle on the card: the whole
    radius-padded stream, every natural output frame, positions from exact
    host integers."""
    from clownresampler_tpu_torch import fixedpoint as fx
    from clownresampler_tpu_torch.configure import configure
    from clownresampler_tpu_torch.models import DEFAULT_MODEL, table_tensor
    from clownresampler_tpu_torch.ops.convolve import ConfigScalars, convolve_frames

    dev = torch.device("cuda")
    cfg = configure(in_rate, out_rate, max(in_rate, out_rate))
    inc = fx.calculate_ratio(in_rate, out_rate)
    r = cfg.integer_stretched_kernel_radius
    n = data.shape[0]
    padded = np.zeros((n + 2 * r, data.shape[1]), np.int16)
    padded[r : r + n] = data
    m = -(-(n << 16) // inc)
    t = np.arange(m, dtype=np.int64) * inc
    table = table_tensor(DEFAULT_MODEL.table(), dev)
    x = torch.from_numpy(padded).to(dev)
    scalars = ConfigScalars.from_configuration(cfg, inc, dev)
    step = max(1, (1 << 22) // fx.round_up(2 * r, 8))
    return np.concatenate([
        convolve_frames(table, x, torch.from_numpy(t[i : i + step] >> 16),
                        torch.from_numpy(t[i : i + step] & 0xFFFF), scalars,
                        fx.round_up(2 * r, 8)).cpu().numpy()
        for i in range(0, m, step)])


SPLIT = ("stage_ms", "launch_issue_ms", "to_host_ms")
# Inside the staging: the programs' stage (FarmProgram.stage: the chunk's way
# to the card and the stage launch issued) and, inside that, their upload
# (FarmProgram.upload: the farm library's host threads copying the chunk into
# the pinned input, each piece's upload issued as it lands; or the upload
# alone); with ``wait_staging`` also the wait, after the staging returns, for
# the card to have done it.
STAGE_SPLIT = ("stage_issue_ms", "upload_ms", "stage_wait_ms")


def drive_farm(farm, chunks, feed=lambda farm, chunk: farm.process(chunk),
               split: bool = False, expect=None, wait_staging: bool = False) -> dict:
    """Feed every chunk then flush; each call is timed on the host clock (it
    ends in a device-to-host copy, so the device work is done) and the first
    is left out as warm-up. Returns outputs and per-call times. Every
    output is kept to the end (a result a later call overwrote would fail
    the checks that follow) unless ``expect`` gives the outputs another run
    kept: each output is then held against it outside the clock and dropped,
    as a caller that consumes its results does. With
    ``split`` the farm's staging, launch issue and copy out (``_stage``,
    ``_launch``, ``_to_host``) are timed on the host clock inside each call
    (the copy out waits for the launch, so it holds the device time), and
    inside the staging its programs' stage and upload (STAGE_SPLIT; with
    ``wait_staging`` a synchronise after the staging, timed: the call then
    waits for the staging before it issues the launches). ``host_ms`` is the
    call's host part before the stage launch: the staging but the stage
    launch's issue, the host threads' copy included."""
    calls = []
    if split:
        def timed(name, fn, wait=False):
            def wrap(*args, **kwargs):
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                t1 = time.perf_counter()
                calls[-1][name] = calls[-1].get(name, 0.0) + 1e3 * (t1 - t0)
                if wait:
                    torch.cuda.synchronize()
                    calls[-1]["stage_wait_ms"] = 1e3 * (time.perf_counter() - t1)
                return out
            return wrap

        farm._stage = timed(SPLIT[0], farm._stage, wait_staging)
        farm._launch = timed(SPLIT[1], farm._launch)
        farm._to_host = timed(SPLIT[2], farm._to_host)
        for *_, program in farm._programs:
            program.stage = timed(STAGE_SPLIT[0], program.stage)
            program.upload = timed(STAGE_SPLIT[1], program.upload)
    outs, times, sizes = [], [], []
    for k, chunk in enumerate([*chunks, None]):
        torch.cuda.synchronize()
        calls.append({})
        t0 = time.perf_counter()
        out = farm.flush() if chunk is None else feed(farm, chunk)
        if chunk is not None:
            times.append(time.perf_counter() - t0)
            sizes.append(out.size if isinstance(out, np.ndarray) else sum(o.size for o in out))
        if expect is None:
            outs.append(out)
        elif not np.array_equal(out, expect[k]):
            raise AssertionError(f"call {k} of a timed farm != the main path's farm")
        del out
    res = dict(outs=outs, times=times, sizes=sizes)
    if split:
        keys = SPLIT + STAGE_SPLIT[: 3 if wait_staging else 2]
        steady = calls[1 : len(chunks)]
        res["steady_split_ms"] = {k: statistics.median(c.get(k, 0.0) for c in steady)
                                  for k in keys}
        res["steady_split_ms"]["host_ms"] = statistics.median(
            c["stage_ms"] - c.get("stage_issue_ms", 0.0) + c.get("upload_ms", 0.0) for c in steady)
        if wait_staging:
            res["steady_split_ms"]["chunk_to_card_ms"] = statistics.median(
                c["stage_ms"] + c["stage_wait_ms"] for c in steady)
    return res


def _rate(res: dict) -> dict:
    steady_s = sum(res["times"][1:])
    return dict(msamples_per_s=sum(res["sizes"][1:]) / steady_s / 1e6,
                ms_per_process=1e3 * steady_s / (len(res["times"]) - 1),
                ms_per_call=[1e3 * t for t in res["times"]])


def shard_mesh(dp: int = SHARD_DP, sp: int = 1):
    """A (dp, sp) mesh over the machine's cards in turn: on one card every
    shard is that card's."""
    from clownresampler_tpu_torch.parallel import make_mesh

    count = torch.cuda.device_count()
    return make_mesh(dp=dp, sp=sp, devices=[f"cuda:{i % count}" for i in range(dp * sp)])


def run_uniform_farm(spec: dict, rng, chunks=None, mesh=None, expect=None,
                     wait_staging: bool = False) -> dict:
    """``chunks`` (by default spec["chunks"] random ones from ``rng``) through
    a UniformStreamFarm on the card or, with ``mesh``, a ShardedStreamFarm on
    it; ``expect`` and ``wait_staging`` as in drive_farm."""
    import clownresampler_tpu_torch as crt
    from clownresampler_tpu_torch.parallel import ShardedStreamFarm

    if chunks is None:
        chunks = [rng.integers(-32768, 32768,
                               size=(spec["streams"], spec["chunk"], spec["channels"]),
                               dtype=np.int16) for _ in range(spec["chunks"])]
    if mesh is None:
        farm = crt.UniformStreamFarm(spec["streams"], spec["channels"], *spec["rates"],
                                     chunk_frames=spec["chunk"], device=DEVICE)
    else:
        farm = ShardedStreamFarm(mesh, spec["streams"], spec["channels"], *spec["rates"],
                                 chunk_frames=spec["chunk"])
    res = drive_farm(farm, chunks, split=True, expect=expect, wait_staging=wait_staging)
    res.update(chunks=chunks, frames=[o.shape[1] for o in res["outs"][:-1]])
    res.update(_rate(res))
    return res


def check_uniform_farm(spec: dict, res: dict) -> list:
    got = np.concatenate(res["outs"], axis=1)
    for i in spec["sampled"]:
        data = np.concatenate([c[i] for c in res["chunks"]], axis=0)
        want = oracle_stream(data, *spec["rates"])
        if not np.array_equal(got[i], want):
            raise AssertionError(f"farm {spec['rates']} stream {i} != gather oracle")
    if got.shape != (spec["streams"], want.shape[0], spec["channels"]):
        raise AssertionError(f"farm output shape {got.shape}")
    return list(got.shape)


def run_mixed_farm(rng, chunks=None, mesh=None) -> dict:
    """Config 5 through MixedStreamFarm (with ``mesh``: ShardedMixedStreamFarm
    on it); after MIXED["adjust_after"] chunks stream MIXED["moved"] moves to
    MIXED["moved_to"]."""
    import clownresampler_tpu_torch as crt
    from clownresampler_tpu_torch.parallel import ShardedMixedStreamFarm

    m = MIXED
    specs = [rates for rates in m["groups"] for _ in range(m["per_group"])]
    n = len(specs)
    if chunks is None:
        chunks = [rng.integers(-32768, 32768, size=(n, m["chunk"], m["channels"]),
                               dtype=np.int16) for _ in range(m["chunks"])]
    if mesh is None:
        farm = crt.MixedStreamFarm(specs, m["channels"], chunk_frames=m["chunk"],
                                   max_radius=m["max_radius"], device=DEVICE)
    else:
        farm = ShardedMixedStreamFarm(mesh, specs, m["channels"], chunk_frames=m["chunk"],
                                      max_radius=m["max_radius"])

    def feed(farm, chunk):
        if feed.calls == m["adjust_after"] and not farm.adjust_stream(m["moved"], *m["moved_to"]):
            raise AssertionError("adjust_stream refused the move")
        feed.calls += 1
        return farm.process(list(chunk))

    feed.calls = 0
    res = drive_farm(farm, chunks, feed)
    res.update(specs=specs, chunks=chunks, groups=len(farm._groups))
    res.update(_rate(res))
    return res


def lowlevel_replay(data: np.ndarray, rates: tuple, chunk: int, adjust_after: int,
                    moved_to: tuple, r_bound: int) -> np.ndarray:
    """A stream through LowLevelResampler on the CPU (the plain versions) on
    a farm's schedule: after each chunk it resamples every received frame
    but a radius_bound hold-back, flush adds radius_bound zero frames, and
    the adjust lands before chunk ``adjust_after``."""
    import clownresampler_tpu_torch as crt

    ch = data.shape[1]
    rs = crt.LowLevelResampler.init(ch, *rates, max(rates), max_radius=r_bound,
                                    device="cpu")
    zeros = np.zeros((r_bound, ch), np.int16)
    padded = np.concatenate([zeros, data, zeros])
    n_chunks = data.shape[0] // chunk
    frames, consumed, received = [], 0, 0
    for i in range(n_chunks + 1):
        if i == adjust_after and not rs.adjust(*moved_to, max(moved_to)):
            raise AssertionError("LowLevel adjust refused")
        received += chunk if i < n_chunks else r_bound
        n_visible = received - consumed - r_bound
        if n_visible <= 0:
            continue
        r = rs.config.integer_stretched_kernel_radius
        start = r_bound + consumed - r
        _, remaining, f = rs.resample(padded[start : start + n_visible + 2 * r], n_visible)
        frames.append(f)
        consumed += n_visible - remaining
    return np.concatenate(frames)


def check_mixed_farm(res: dict) -> dict:
    m = MIXED
    streams = len(res["specs"])
    got = [np.concatenate([outs[i] for outs in res["outs"]], axis=0) for i in range(streams)]
    sampled = [g * m["per_group"] + 1 for g in range(len(m["groups"]))]
    for i in sampled:
        data = np.concatenate([c[i] for c in res["chunks"]], axis=0)
        if not np.array_equal(got[i], oracle_stream(data, *res["specs"][i])):
            raise AssertionError(f"mixed farm stream {i} {res['specs'][i]} != gather oracle")
    i = m["moved"]
    data = np.concatenate([c[i] for c in res["chunks"]], axis=0)
    want = lowlevel_replay(data, res["specs"][i], m["chunk"], m["adjust_after"],
                           m["moved_to"], m["max_radius"])
    if not np.array_equal(got[i], want):
        raise AssertionError(f"moved stream {i} != LowLevelResampler replay")
    return dict(sampled_streams_exact=sampled, moved_stream_exact=i,
                moved_frames=int(want.shape[0]), groups_after_adjust=res["groups"])


def run_wide_paths(rng) -> dict:
    import clownresampler_tpu_torch as crt
    from clownresampler_tpu_torch.utils.audio_io import read_raw_s16le

    pcm = read_raw_s16le(PCM, channels=2)
    array_out = crt.resample_array(pcm, *WIDE_FARM["rates"], max(WIDE_FARM["rates"]),
                                   device="cuda")
    general = {rates: crt.resample_array(pcm, *rates, max(rates), device="cuda")
               for rates in GENERAL_WIDE_RATES}
    return dict(pcm=pcm, array_out=array_out, general=general,
                farm=run_uniform_farm(WIDE_FARM, rng))


def scan_case(rates, lanes: int, k: int, gen) -> dict:
    """K random int16 chunks of SCAN7["n_in"] frames and one zero chunk on
    the card, with config 7's geometry (run_all.py:509-515): taps the radius
    rounded up to 8, n_out ((n_in + 2r) << 16) // increment + 8 rounded up
    to 128."""
    from clownresampler_tpu_torch import fixedpoint as fx
    from clownresampler_tpu_torch.configure import configure
    from clownresampler_tpu_torch.lowlevel import make_device_state
    from clownresampler_tpu_torch.models import DEFAULT_MODEL, table_tensor

    dev = torch.device(DEVICE)
    n_in = SCAN7["n_in"]
    cfg = configure(*rates, max(rates))
    inc = fx.calculate_ratio(*rates)
    r = cfg.integer_stretched_kernel_radius
    taps = fx.round_up(2 * r, 8)
    chunks = torch.randint(-32768, 32768, (k + 1, n_in, lanes), generator=gen,
                           dtype=torch.int32, device=dev).to(torch.int16)
    chunks[k] = 0
    return dict(rates=rates, chunks=chunks, cfg=cfg, increment=inc, radius=r, max_taps=taps,
                n_out=fx.round_up((((n_in + 2 * r) << 16) // inc) + 8, 128),
                state=make_device_state(0, 0, cfg, inc, dev),
                table=table_tensor(DEFAULT_MODEL.table(), dev),
                table_strided=table_tensor(
                    DEFAULT_MODEL.strided_table(cfg.kernel_step_size, taps), dev))


def fused_scan(c: dict, k=None):
    """resample_scan_fused over the first k chunks (all by default) with
    sync debug mode "error" from the call to its return: a host sync
    anywhere in it raises. The mode is back to default before any read."""
    from clownresampler_tpu_torch.lowlevel import resample_scan_fused

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return resample_scan_fused(c["table"], c["chunks"][:k], c["state"], **scan_args(c))
    finally:
        torch.cuda.set_sync_debug_mode("default")


def scan_args(c: dict) -> dict:
    return dict(max_taps=c["max_taps"], n_out=c["n_out"], radius=c["radius"],
                increment=c["increment"], table_strided=c["table_strided"])


def run_scans(gen) -> dict:
    """Config 7's scan and the other engines' scans (main path). Each scan's
    own launch counts must be its engine's scan mode's and nothing else's:
    one tiled_mac_kernel launch a request for the tiled and general engines,
    one strided_mac_kernel launch a step for the strided one, a
    wide_mac_kernel and wide_fold_kernel launch a launch offset for the wide
    one (any other route, a staging kernel's or an entry's, fails)."""
    from clownresampler_tpu_torch.lowlevel import SCAN_ROUTES, WHOLE_SCAN_KINDS, _scan_engine
    from clownresampler_tpu_torch.ops.resample import ROUTES

    runs = {}
    for rates, lanes, k in ((SCAN7["rates"], SCAN7["lanes"], SCAN7["chunks"]),
                            *((r, l, SCAN_ENGINE_CHUNKS) for r, l in SCAN_ENGINES)):
        c = scan_case(rates, lanes, k, gen)
        before = dict(ROUTES)
        t0 = time.perf_counter()
        res = fused_scan(c)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = {key: n - before.get(key, 0) for key, n in ROUTES.items()
                  if n != before.get(key, 0)}
        runs[rates] = dict(case=c, result=res, seconds=seconds,
                           launch_counts={"/".join(key): n for key, n in counts.items()})
        kind, _, _, step = _scan_engine(c["increment"], c["max_taps"], c["n_out"])
        want = {(SCAN_ROUTES[kind], "cuda"):
                1 if kind in WHOLE_SCAN_KINDS else (k + 1) * -(-c["n_out"] // step)}
        if counts != want:
            raise AssertionError(f"scan {rates} ({kind} engine) launched {counts}, not {want}")
    return runs


def check_scan(run: dict) -> dict:
    """The fused scan (the device program) against its plain version on the
    card over every lane, and against the port's oracle scan over lanes 0-3
    and the last four: outputs, produced, state and backlog, exact."""
    from clownresampler_tpu_torch.lowlevel import resample_scan, resample_scan_fused_reference

    c, (out, produced, state, backlog) = run["case"], run["result"]
    plain = resample_scan_fused_reference(c["table"], c["chunks"], c["state"], **scan_args(c))
    same = (torch.equal(out, plain[0]) and produced.dtype == plain[1].dtype
            and torch.equal(produced, plain[1]) and bool(backlog) == bool(plain[3])
            and torch.equal(state.position_integer, plain[2].position_integer)
            and torch.equal(state.position_fractional, plain[2].position_fractional))
    if not same:
        raise AssertionError(f"scan {c['rates']} != resample_scan_fused_reference")
    del plain
    lanes = c["chunks"].shape[2]
    cols = [0, 1, 2, 3, lanes - 4, lanes - 3, lanes - 2, lanes - 1]
    idx = torch.tensor(cols, device=out.device)
    ref = resample_scan(c["table"], c["chunks"].index_select(2, idx), c["state"],
                        max_taps=c["max_taps"], n_out=c["n_out"], radius=c["radius"])
    pos = (int(state.position_integer), int(state.position_fractional))
    if bool(backlog) or bool(ref[3]):
        raise AssertionError(f"scan {c['rates']}: backlog {bool(backlog)}, oracle {bool(ref[3])}")
    if not (torch.equal(out.index_select(2, idx), ref[0]) and torch.equal(produced, ref[1])
            and pos == (int(ref[2].position_integer), int(ref[2].position_fractional))):
        raise AssertionError(f"scan {c['rates']} != oracle scan on lanes {cols}")
    return dict(rates=c["rates"], lanes=lanes, chunks=c["chunks"].shape[0], n_in=SCAN7["n_in"],
                n_out=c["n_out"], taps=c["max_taps"], produced_frames=int(produced.sum()),
                launch_counts=run.get("launch_counts"),
                state=list(pos), backlog=False, plain_version_exact="every lane",
                oracle_lanes_exact=cols,
                seconds_with_no_sync=run["seconds"])


def check_scan_replay(run: dict, streams) -> list:
    """Streams of the scan against a CPU LowLevelResampler over the whole
    stream and the zero chunk: the scan drains all but the flush's last
    radius input frames (held back by the position bias), which are
    silence."""
    import clownresampler_tpu_torch as crt

    c, (out, produced, _, _) = run["case"], run["result"]
    prod = produced.cpu().numpy()
    for s in streams:
        lanes = slice(2 * s, 2 * s + 2)
        got = out[:, :, lanes].cpu().numpy()
        got = np.concatenate([got[i, : prod[i]] for i in range(len(prod))])
        data = c["chunks"][:, :, lanes].cpu().numpy().reshape(-1, 2)
        rs = crt.LowLevelResampler.init(2, *c["rates"], max(c["rates"]), device="cpu")
        pad = np.zeros((c["radius"], 2), np.int16)
        _, _, want = rs.resample(np.concatenate([pad, data, pad]), data.shape[0])
        tol = (c["radius"] << 16) // c["increment"] + 3
        if not (np.array_equal(got, want[: got.shape[0]]) and not want[got.shape[0]:].any()
                and got.shape[0] >= want.shape[0] - tol):
            raise AssertionError(f"scan stream {s} != LowLevelResampler replay")
    return list(streams)


def profile_scan_program(c: dict, k: int, attempts: int = 3) -> dict:
    """The step loop of one scan (``ScanProgram.run`` over the first k
    chunks, set up outside) under torch.profiler with memory profiling on:
    fails unless the loop ran no ``aten::`` op, allocated and freed nothing
    and put exactly its kernels on the card -- one tiled_mac_kernel a
    request for the tiled and general engines; a step is its engine's
    scan-mode launches for the others: one strided_mac_kernel for the
    strided one, a wide_mac_kernel and a wide_fold_kernel a launch offset for
    the wide one. The profiler now
    and then loses a kernel's record, so a count that is off is taken again
    with a new program, up to ``attempts`` times; an aten op, a memory event
    or an activity that is none of the loop's kernels fails at once. Returns
    the device activities a step, the device time a step by kernel, and the
    device's busy share of the loop's wall time (profiled: the profiler slows
    the host's issue)."""
    from clownresampler_tpu_torch.lowlevel import WHOLE_SCAN_KINDS, ScanProgram

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for attempt in range(1, attempts + 1):
        program = ScanProgram(c["table"], c["chunks"][:k], c["state"], **scan_args(c))
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts, profile_memory=True) as prof:
            torch.cuda.synchronize()  # the tracer is up before the first launch
            t0 = time.perf_counter()
            program.run()
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        device_us, counts, aten, memory_events = {}, {}, [], 0
        for evt in prof.key_averages():
            if evt.device_type == torch.autograd.DeviceType.CUDA:
                device_us[evt.key] = device_us.get(evt.key, 0) + evt.self_device_time_total
                counts[evt.key] = counts.get(evt.key, 0) + evt.count
            elif evt.key.startswith("aten::"):
                aten.append(evt.key)
            elif evt.key == "[memory]":
                memory_events += evt.count
        kernels = ENTRY_KERNELS[program.kind]
        strangers = [key for key in counts if not any(name in key for name in kernels)]
        if aten or memory_events or strangers:
            raise AssertionError(
                f"scan {c['rates']}: the step loop ran aten ops {aten}, {memory_events} memory "
                f"events and device activities other than its kernels: {strangers}")
        want = program.launches * len(kernels) * (1 if program.kind in WHOLE_SCAN_KINDS else k)
        if sum(counts.values()) == want:
            break
        if attempt == attempts:
            raise AssertionError(
                f"scan {c['rates']}: {counts} device activities over {k} steps in each of "
                f"{attempts} profiles (wanted {want})")
    total_us = sum(device_us.values())
    return dict(rates=c["rates"], engine=program.kind, steps=k, lanes=c["chunks"].shape[2],
                aten_ops=0, memory_events=0,
                profiles_taken=attempt, device_activities_per_step=want / k,
                device_ms_per_step=total_us / 1e3 / k,
                device_ms_per_step_by_kernel={key[:60]: v / 1e3 / k
                                              for key, v in sorted(device_us.items())},
                profiled_wall_ms=wall_ms, profiled_device_busy_share=total_us / 1e3 / wall_ms)


def scan_step_bound(c: dict, state, k: int, produced: int, peaks: dict) -> dict:
    """The least time the card could take for step k of scan case c in scan
    mode from ``state`` (2,), whatever its engine: the larger of its bytes --
    the stream rows its produced frames' windows reach inside the step's live
    rows [k*n_in - 2r, (k+1)*n_in), read once at the chunks' width, and the
    (n_out, L) int32 output written once (the wide engine's partial sums are
    its own scratch, not the function's) -- over the HBM rate, and
    OPS_PER_TAP operations for each live tap and lane of the produced frames
    (the others store zeros) over the int32 rate."""
    from clownresampler_tpu_torch import fixedpoint as fx
    from clownresampler_tpu_torch.ops.convolve import window_geometry

    cfg, taps, n_out = c["state"].cfg, c["max_taps"], c["n_out"]
    _, n_in, lanes = c["chunks"].shape
    first, end = k * n_in - 2 * c["radius"], (k + 1) * n_in
    n = torch.arange(produced, dtype=torch.int32, device=state.device)
    pos, frac = fx.positions_from_state(state[0], state[1], cfg.increment_hi, cfg.increment_lo,
                                        n)
    min_rel, _, _, live = window_geometry(cfg, frac)
    live = live.clamp(0, taps)
    rows = pos + min_rel          # window rows of the staged buffer the step stands for
    span = 0
    if produced:
        span = max(min(int((rows + live).max()), end - first) - max(int(rows[0]), -first, 0), 0)
    nbytes = span * lanes * c["chunks"].element_size() + 4 * n_out * lanes
    ops = OPS_PER_TAP * int(live.sum()) * lanes
    memory_ms = 1e3 * nbytes / peaks["hbm_bytes_per_s"]
    ops_ms = 1e3 * ops / peaks["int32_ops_per_s"]
    return dict(bound_ms=max(memory_ms, ops_ms),
                bound_by="bytes" if memory_ms >= ops_ms else "operations",
                bytes=nbytes, int32_ops=ops, memory_ms=memory_ms, operations_ms=ops_ms,
                window_rows_read=span, produced=produced)


def time_scan_step(c: dict, peaks: dict) -> dict:
    """An engine's scan mode alone at the step of scan case c (step 1 of its
    chunks, from the state (radius + 2, 0x8421)): its C entries as the scan
    calls them (lowlevel._scan_step_launches, arguments built once), CUDA
    events around 20 back-to-back steps after 20 untimed, the result then
    checked against the plain version; the plain version's time; the bound
    (scan_step_bound)."""
    from clownresampler_tpu_torch import lowlevel
    from clownresampler_tpu_torch.ops import _build

    dev = torch.device(DEVICE)
    r, n_out, taps, inc, k = c["radius"], c["n_out"], c["max_taps"], c["increment"], 1
    chunks, cfg = c["chunks"], c["state"].cfg
    lanes = chunks.shape[2]
    state = torch.tensor([r + 2, 0x8421], dtype=torch.int32).to(dev)
    out = torch.empty((n_out, lanes), dtype=torch.int32, device=dev)
    book = torch.empty(4, dtype=torch.int32, device=dev)
    launches = lowlevel._scan_step_launches(
        c["table"], chunks, state, cfg, out, book[0:1], book[1:2], book[2:4], k=k, radius=r,
        max_taps=taps, increment=inc, table_strided=c["table_strided"],
        partial=lowlevel._wide_scratch(chunks, inc, taps, n_out))
    calls = [(_build.entry_function(entry), entry, _build.ordered_args(entry, args))
             for entry, args in launches]

    def issue(reps):
        for _ in range(reps):
            for fn, entry, args in calls:
                _build.raise_on_launch(fn(*args), entry)

    reps = 20
    issue(reps)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    issue(reps)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / reps
    plain = lambda: lowlevel.scan_inplace_step_reference(
        c["table"], chunks, k, state, cfg, radius=r, max_taps=taps, n_out=n_out, increment=inc,
        table_strided=c["table_strided"])
    want = plain()
    if not all(torch.equal(g, w) for g, w in zip((out, book[0], book[1], book[2:4]), want)):
        raise AssertionError(f"the timed scan-mode launches at {c['rates']} != the plain version")
    bound = scan_step_bound(c, state, k, int(want[1]), peaks)
    first = launches[0][1]
    stage = {key: first[key] for key in ("frames_per_stage", "frames_per_tile", "win_rows")
             if key in first}
    return dict(ms=ms, plain_ms=cuda_ms(lambda: plain()[0]), **bound,
                bound_share=bound["bound_ms"] / ms,
                achieved_bytes_per_s=bound["bytes"] / (ms / 1e3),
                c_calls_per_step=len(calls), stage=stage, copy=SCAN_COPY_NAMES[first["copy"]],
                shape=f"chunks {tuple(chunks.shape)} {str(chunks.dtype)[6:]}, step {k}, "
                      f"halo {2 * r} rows, n_out {n_out}, taps {taps}")


def scan_slope(c: dict) -> dict:
    """A scan's per-chunk time: the K-slope of the fused scan between
    SCAN7["timing_k"] chunks of case c (every step's output kept), CUDA
    events around each run, best of 3 after a warm-up, with the host's time
    to issue a run (the call's return, before any synchronise) beside it,
    the peak device memory of one run at the larger K, and the step loop's
    own host time a step (``ScanProgram.run`` alone)."""
    from clownresampler_tpu_torch.lowlevel import ScanProgram

    k1, k2 = SCAN7["timing_k"]
    lanes = c["chunks"].shape[2]
    fused_scan(c, k1)

    def timed(k):
        best, issue, produced = None, None, None
        for _ in range(3):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            torch.cuda.synchronize()
            start.record()
            t0 = time.perf_counter()
            res = fused_scan(c, k)
            issued = 1e3 * (time.perf_counter() - t0)
            end.record()
            torch.cuda.synchronize()
            best = min(best or 1e30, start.elapsed_time(end))
            issue = min(issue or 1e30, issued)
            produced = int(res[1].sum())
            del res  # one run's outputs alive at a time: the peak is one scan's
        return best, issue, produced

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    (t1, i1, p1), (t2, i2, p2) = timed(k1), timed(k2)
    peak = torch.cuda.max_memory_allocated()
    ms_per_chunk = (t2 - t1) / (k2 - k1)
    # The step loop alone: set-up outside the clock, no synchronise inside it.
    loop_us = []
    for _ in range(3):
        program = ScanProgram(c["table"], c["chunks"][:k2], c["state"], **scan_args(c))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        program.run()
        loop_us.append(1e6 * (time.perf_counter() - t0) / k2)
        torch.cuda.synchronize()
        del program
    return dict(rates=c["rates"], lanes=lanes, n_in=c["chunks"].shape[1], n_out=c["n_out"],
                taps=c["max_taps"], k=[k1, k2], run_ms=[t1, t2], ms_per_chunk=ms_per_chunk,
                msamples_per_s=(p2 - p1) * lanes / (ms_per_chunk * (k2 - k1)) / 1e3,
                produced_frames=[p1, p2], peak_allocated_bytes_k40=peak,
                peak_over_inputs_bytes_k40=peak - base,
                host_issue_ms=[i1, i2], host_issue_us_per_chunk=1e3 * (i2 - i1) / (k2 - k1),
                step_loop_host_us_per_step=min(loop_us), step_loop_host_us_per_step_runs=loop_us)


def time_scan(gen, peaks: dict) -> dict:
    """Config 7's and the strided engine's per-chunk times (scan_slope: the
    K-slope, the host's issue, peak memory, the step loop's host us a step);
    each engine's scan mode alone at its step beside its bound
    (time_scan_step: config 7's general step, the tiled, strided and wide
    engines' at SCAN_ENGINES); one step's scan_inplace_step (events) beside
    its device activities and their time (torch.profiler); then, last (a
    profiler run slows later launches), each engine's step loop under
    torch.profiler (profile_scan_program)."""
    from clownresampler_tpu_torch.lowlevel import scan_inplace_step

    k1, k2 = SCAN7["timing_k"]
    c = scan_case(SCAN7["rates"], SCAN7["lanes"], k2 - 1, gen)
    config7 = scan_slope(c)
    strided = scan_case(*SCAN_ENGINES[1], k2 - 1, gen)
    strided_slope = scan_slope(strided)
    del strided
    modes = {"config7": time_scan_step(c, peaks)}
    for name, (rates, lanes) in zip(("tiled", "strided", "wide"), SCAN_ENGINES):
        e = scan_case(rates, lanes, 1, gen)
        modes[name] = time_scan_step(e, peaks)
        del e

    # One step through scan_inplace_step: step 0 from the first step's state.
    r, taps, n_out = c["radius"], c["max_taps"], c["n_out"]
    st = torch.tensor([r, 0], dtype=torch.int32).to(DEVICE)
    args = dict(radius=r, max_taps=taps, n_out=n_out, increment=c["increment"],
                table_strided=c["table_strided"])
    entry = lambda: scan_inplace_step(c["table"], c["chunks"], 0, st, c["state"].cfg,
                                      **args)[0]
    split = dict(entry_ms=cuda_ms(entry))
    split["device_activities"], split["device_ms"] = device_launches(entry)

    profiles = [profile_scan_program(c, k1)]
    del c
    for rates, engine_lanes in SCAN_ENGINES:
        e = scan_case(rates, engine_lanes, SCAN_ENGINE_CHUNKS, gen)
        profiles.append(profile_scan_program(e, SCAN_ENGINE_CHUNKS + 1))
        del e
    for slope, profile in ((config7, profiles[0]), (strided_slope, profiles[2])):
        device_ms = profile["device_ms_per_step"]
        slope.update(device_busy_share=device_ms / slope["ms_per_chunk"],
                     host_bound=slope["step_loop_host_us_per_step"] / 1e3 > device_ms)
    return dict(**config7, strided_scan=strided_slope, scan_modes=modes, step_launch=split,
                step_loops=profiles)


def run_checkpoints(rng) -> dict:
    """The headline farm saved after CKPT["saved_after"] chunks and restored
    on the card; config 5 saved after its adjust_stream and restored on the
    card; every farm continues (main path). The CPU restore is a check."""
    import clownresampler_tpu_torch as crt
    from clownresampler_tpu_torch import checkpoint as ckpt

    f, n_saved = FARM, CKPT["saved_after"]
    chunks = [rng.integers(-32768, 32768, size=(f["streams"], f["chunk"], f["channels"]),
                           dtype=np.int16) for _ in range(n_saved + CKPT["continued"])]
    farm = crt.UniformStreamFarm(f["streams"], f["channels"], *f["rates"],
                                 chunk_frames=f["chunk"], device=DEVICE)
    for chunk in chunks[:n_saved]:
        farm.process(chunk)
    snap = ckpt.save_farm(farm)
    restored = ckpt.load_farm(snap, device=DEVICE)
    finish = lambda fm: np.concatenate(
        [fm.process(ch) for ch in chunks[n_saved:]] + [fm.flush()], axis=1)
    want, got = finish(farm), finish(restored)

    m = MIXED
    specs = [rates for rates in m["groups"] for _ in range(m["per_group"])]
    mchunks = [rng.integers(-32768, 32768, size=(len(specs), m["chunk"], m["channels"]),
                            dtype=np.int16) for _ in range(4)]
    mixed = crt.MixedStreamFarm(specs, m["channels"], chunk_frames=m["chunk"],
                                max_radius=m["max_radius"], device=DEVICE)
    for i in range(3):
        if i == 2 and not mixed.adjust_stream(m["moved"], *m["moved_to"]):
            raise AssertionError("adjust_stream refused the move")
        mixed.process(list(mchunks[i]))
    mrestored = ckpt.load_mixed_farm(ckpt.save_mixed_farm(mixed), device=DEVICE)
    mfinish = lambda fm: [fm.process(list(mchunks[3])), fm.flush()]
    return dict(snap=snap, chunks=chunks, want=want, got=got, mwant=mfinish(mixed),
                mgot=mfinish(mrestored), groups=len(mixed._groups))


def check_checkpoints(res: dict) -> dict:
    from clownresampler_tpu_torch import checkpoint as ckpt

    if not np.array_equal(res["got"], res["want"]):
        raise AssertionError("farm restored on the card != the uninterrupted farm")
    s, n_saved = CKPT["sampled"], CKPT["saved_after"]
    snap = res["snap"]
    solo = ckpt.load_farm(dict(snap, n_streams=1, staging=snap["staging"][:, 2 * s : 2 * s + 2]),
                          device="cpu")
    got = np.concatenate([solo.process(ch[s : s + 1]) for ch in res["chunks"][n_saved:]]
                         + [solo.flush()], axis=1)
    if not np.array_equal(got, res["want"][s : s + 1]):
        raise AssertionError(f"stream {s} restored on the CPU != the uninterrupted farm")
    for step_want, step_got in zip(res["mwant"], res["mgot"]):
        for i, (w, g) in enumerate(zip(step_want, step_got)):
            if not np.array_equal(w, g):
                raise AssertionError(f"mixed farm restored on the card: stream {i} differs")
    return dict(farm_streams=FARM["streams"], saved_after_chunks=n_saved,
                continued_chunks=CKPT["continued"], card_to_card_exact=True,
                card_to_cpu_stream_exact=s, continued_frames=int(res["want"].shape[1]),
                mixed_groups=res["groups"], mixed_card_to_card_exact=True)


def batch_case(rng, spec: dict = BATCH) -> dict:
    """``spec``'s (BATCH's or FLEET's) inputs on the card: stream i at config
    5's ratio i % 4 with quota (i // 4) % 6 of spec["quotas"], its n_in
    random frames padded by MIXED's radius reserve on both sides; ``buf``
    the input in host memory, ``rates`` each stream's ratio."""
    from clownresampler_tpu_torch import fixedpoint as fx
    from clownresampler_tpu_torch.batch import make_batch_state
    from clownresampler_tpu_torch.configure import configure
    from clownresampler_tpu_torch.models import DEFAULT_MODEL, table_tensor

    r_max = MIXED["max_radius"]
    dev = torch.device(DEVICE)
    cfgs, rates = [], []
    buf = np.zeros((spec["streams"], spec["n_in"] + 2 * r_max, spec["channels"]), np.int16)
    for i in range(spec["streams"]):
        rates.append(MIXED["groups"][i % len(MIXED["groups"])])
        cfg = configure(*rates[-1], max(rates[-1]))
        cfgs.append((cfg, fx.calculate_ratio(*rates[-1])))
        r = cfg.integer_stretched_kernel_radius
        buf[i, r : r + spec["n_in"]] = rng.integers(-32768, 32768,
                                                    size=(spec["n_in"], spec["channels"]))
    quotas = [spec["quotas"][(i // 4) % len(spec["quotas"])] for i in range(spec["streams"])]
    args = (table_tensor(DEFAULT_MODEL.table(), dev), torch.from_numpy(buf).to(dev),
            torch.full((spec["streams"],), spec["n_in"], dtype=torch.int32, device=dev),
            make_batch_state(cfgs, device=dev),
            torch.tensor(quotas, dtype=torch.int32, device=dev))
    return dict(args=args, kw=dict(max_taps=fx.round_up(2 * r_max, 8), n_out=spec["n_out"]),
                buf=buf, rates=rates, quotas=quotas)


def run_fleet_batch(rng) -> dict:
    """Config 5's fleet (FLEET) as one resample_batch call (main path)."""
    from clownresampler_tpu_torch.batch import resample_batch

    case = batch_case(rng, FLEET)
    return dict(case=case, out=resample_batch(*case["args"], **case["kw"]))


def check_fleet_batch(res: dict) -> dict:
    """The fleet's call against its plain version on the card (every leaf,
    exact) and FLEET["replay"]'s streams against a CPU LowLevelResampler
    replay of the same chunk and quota (frames, produced, consumed, state,
    exhausted)."""
    import clownresampler_tpu_torch as crt
    from clownresampler_tpu_torch.batch import resample_batch_reference

    case, got = res["case"], res["out"]
    want = resample_batch_reference(*case["args"], **case["kw"])
    for i, (g, w) in enumerate(zip(_batch_leaves(got), _batch_leaves(want))):
        if g.shape != w.shape or g.dtype != w.dtype or not torch.equal(g, w):
            raise AssertionError(f"resample_batch != its plain version on the fleet, leaf {i}")
    del want
    out = got[0]
    produced, consumed, exhausted = (v.cpu().numpy() for v in (got[1], got[2], got[4]))
    positions = [v.cpu().numpy() for v in (got[3].position_integer, got[3].position_fractional)]
    n_in, n_out = FLEET["n_in"], FLEET["n_out"]
    for i in FLEET["replay"]:
        ll = crt.LowLevelResampler.init(FLEET["channels"], *case["rates"][i],
                                        max(case["rates"][i]), device="cpu")
        done, remaining, frames = ll.resample(case["buf"][i], n_in,
                                              output_limit=min(case["quotas"][i], n_out))
        k = frames.shape[0]
        stream = out[i].cpu().numpy()
        if (k != produced[i] or not np.array_equal(stream[:k], frames) or stream[k:].any()
                or n_in - remaining != consumed[i] or done != bool(exhausted[i])
                or (ll.position_integer, ll.position_fractional)
                != (positions[0][i], positions[1][i])):
            raise AssertionError(f"fleet stream {i} != its CPU LowLevelResampler replay")
    return dict(streams=FLEET["streams"], channels=FLEET["channels"], n_in=n_in, n_out=n_out,
                taps=case["kw"]["max_taps"], tolerance="exact equality, every leaf",
                plain_version_exact=True, replayed_streams_exact=list(FLEET["replay"]),
                produced_min_max=[int(produced.min()), int(produced.max())],
                output_full_streams=int((produced == n_out).sum()),
                exhausted=int(exhausted.sum()), input_mb=case["buf"].nbytes / 1e6,
                output_mb=out.numel() * 4 / 1e6)


def looped_resample_batch(table, inputs, totals, states, quotas, *, max_taps, n_out):
    """resample_chunk stream by stream from Python, stacked: the loop that
    batch.resample_batch's one batched call replaced, kept here to time the
    two side by side."""
    from clownresampler_tpu_torch.batch import stack_states
    from clownresampler_tpu_torch.lowlevel import DeviceState, resample_chunk
    from clownresampler_tpu_torch.ops.convolve import ConfigScalars

    res = [resample_chunk(table, inputs[b], totals[b],
                          DeviceState(states.position_integer[b], states.position_fractional[b],
                                      ConfigScalars(*(f[b] for f in states.cfg))),
                          quotas[b], max_taps=max_taps, n_out=n_out)
           for b in range(inputs.shape[0])]
    out, produced, consumed, new_states, exhausted = zip(*res)
    return (torch.stack(out), torch.stack(produced), torch.stack(consumed),
            stack_states(list(new_states)), torch.stack(exhausted))


def _batch_leaves(result) -> list:
    out, produced, consumed, state, exhausted = result
    return [out, produced, consumed, state.position_integer, state.position_fractional,
            *state.cfg, exhausted]


def run_example() -> dict:
    """The multichip example on the card as a subprocess (it loads the
    kernel libraries this run built)."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "clownresampler_tpu_torch.examples.multichip_farm",
         "--device", DEVICE], cwd=ROOT, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise AssertionError(f"multichip example exited {proc.returncode}: {proc.stderr[-800:]}")
    return dict(seconds=time.perf_counter() - t0, printed=proc.stdout.strip().splitlines())


# The ways a chunk enters a farm on the card (ROUTES ("farm_input", route)):
# straight from the caller's C-contiguous int16 array through the farm
# library's host threads, converted into the pinned input first, or a mixed
# farm's streams stacked straight into it.
INPUT_ROUTES = ("direct", "converted", "stacked")
# The headline farm's first chunks in forms a caller may hand it, each to
# take its route: (name, form of the int16 chunk, route).
INPUT_FORMS = (("int16", lambda x: x, "direct"),
               ("int32", lambda x: x.astype(np.int32), "converted"),
               ("strided view", lambda x: np.repeat(x, 2, axis=1)[:, ::2], "converted"),
               ("read-only int16", lambda x: _read_only(x.copy()), "direct"))


def _read_only(x: np.ndarray) -> np.ndarray:
    x.flags.writeable = False
    return x


def input_routes(counts: dict) -> dict:
    """The farm_input routes among ROUTES ``counts``."""
    return {impl: n for (kind, impl), n in counts.items() if kind == "farm_input"}


def run_input_routes(farm: dict) -> dict:
    """A fresh headline farm fed the main path's first chunks in the forms of
    INPUT_FORMS, each call held against the main path's output for the same
    chunk and its route against ROUTES."""
    import clownresampler_tpu_torch as crt
    from clownresampler_tpu_torch.ops.resample import ROUTES

    f = FARM
    fm = crt.UniformStreamFarm(f["streams"], f["channels"], *f["rates"], chunk_frames=f["chunk"],
                               device=DEVICE)
    taken = {}
    for k, (name, form, route) in enumerate(INPUT_FORMS):
        chunk = form(farm["chunks"][k])
        before = input_routes(ROUTES)
        out = fm.process(chunk)
        after = input_routes(ROUTES)
        got = {r: after.get(r, 0) - before.get(r, 0) for r in after if after.get(r, 0) !=
               before.get(r, 0)}
        if got != {route: 1}:
            raise AssertionError(f"a {name} chunk took the routes {got}, not {route}")
        if not np.array_equal(out, farm["outs"][k]):
            raise AssertionError(f"a {name} chunk's output != the main path's")
        taken[name] = route
    return dict(forms=taken, exact=True)


def run_sharded_paths(rng, gen, farm: dict, mixed: dict, checkpoints: dict,
                      fleet: dict) -> dict:
    """The sharded paths (main path of parallel/) on shard_mesh(): the
    headline farm and config 5 on the unsharded runs' chunks, the 44.1k ->
    132 farm, the lane-sharded tiled entry at HEADLINE, the fleet batch
    (FLEET, on the unsharded call's inputs) on a FLEET["mesh"] mesh, the
    headline farm saved after CKPT["saved_after"] chunks and restored onto
    the mesh and onto the card (all three continued, on the unsharded
    checkpoint run's chunks), and the example."""
    from clownresampler_tpu_torch import checkpoint as ckpt
    from clownresampler_tpu_torch import parallel

    mesh = shard_mesh()
    res = dict(mesh=repr(mesh))
    res["farm"] = run_uniform_farm(FARM, rng, chunks=farm["chunks"], mesh=mesh)
    res["mixed"] = run_mixed_farm(rng, chunks=mixed["chunks"], mesh=mesh)
    w = WIDE_FARM
    wide_chunks = [rng.integers(-32768, 32768, size=(w["streams"], w["chunk"], w["channels"]),
                                dtype=np.int16) for _ in range(SHARDED_WIDE_CHUNKS)]
    res["wide"] = run_uniform_farm(w, rng, chunks=wide_chunks, mesh=mesh)

    c = launch_case(*HEADLINE["rates"], HEADLINE["lanes"], HEADLINE["n_out"], gen)
    args = dict(max_taps=c["max_taps"], n_out=c["n_out"], d=c["plan"]["d"],
                cand=c["plan"]["cand"])
    res["uniform"] = dict(case=c, args=args, out=parallel.sharded_uniform_resample(
        mesh, c["table"], c["x"], c["state"], **args))

    b = fleet["case"]
    res["batch"] = parallel.sharded_resample_batch(shard_mesh(*FLEET["mesh"]), *b["args"],
                                                   **b["kw"])

    f, n_saved = FARM, CKPT["saved_after"]
    chunks = checkpoints["chunks"]
    sharded = parallel.ShardedStreamFarm(mesh, f["streams"], f["channels"], *f["rates"],
                                         chunk_frames=f["chunk"])
    for chunk in chunks[:n_saved]:
        sharded.process(chunk)
    snap = ckpt.save_farm(sharded)
    on_mesh, on_card = ckpt.load_farm(snap, mesh=mesh), ckpt.load_farm(snap, device=DEVICE)
    if not isinstance(on_mesh, parallel.ShardedStreamFarm) or isinstance(
            on_card, parallel.ShardedStreamFarm):
        raise AssertionError("load_farm restored the wrong kind of farm")
    finish = lambda fm: np.concatenate(
        [fm.process(ch) for ch in chunks[n_saved:]] + [fm.flush()], axis=1)
    res["checkpoint"] = dict(snap=snap, ran_on=finish(sharded), on_mesh=finish(on_mesh),
                             on_card=finish(on_card))
    res["example"] = run_example()
    return res


def check_sharded_paths(res: dict, farm: dict, mixed: dict, checkpoints: dict, fleet: dict,
                        rng) -> dict:
    """Every stream of every sharded path against its unsharded counterpart,
    exact: whole arrays, not samples."""
    from clownresampler_tpu_torch.ops import resample as rs

    for k, (got, want) in enumerate(zip(res["farm"]["outs"], farm["outs"])):
        if not np.array_equal(got, want):
            raise AssertionError(f"sharded headline farm != unsharded farm in call {k}")
    shape = check_uniform_farm(FARM, res["farm"])

    for k, (got, want) in enumerate(zip(res["mixed"]["outs"], mixed["outs"])):
        for i, (g, w) in enumerate(zip(got, want)):
            if not np.array_equal(g, w):
                raise AssertionError(f"sharded mixed farm stream {i} != unsharded in call {k}")
    if res["mixed"]["groups"] != mixed["groups"]:
        raise AssertionError("sharded mixed farm ended with other groups")

    wide_spec = dict(WIDE_FARM, chunks=SHARDED_WIDE_CHUNKS)
    plain = run_uniform_farm(wide_spec, rng, chunks=res["wide"]["chunks"])
    for k, (got, want) in enumerate(zip(res["wide"]["outs"], plain["outs"])):
        if not np.array_equal(got, want):
            raise AssertionError(f"sharded 44.1k->132 farm != unsharded farm in call {k}")
    wide_shape = check_uniform_farm(wide_spec, res["wide"])

    u = res["uniform"]
    c = u["case"]
    want, _ = rs.resample_uniform_lanes_tiled(c["table"], c["x"], c["state"], **u["args"])
    if not torch.equal(u["out"], want):
        raise AssertionError("sharded_uniform_resample != the one-launch tiled entry")

    want = fleet["out"]
    for i, (g, w) in enumerate(zip(_batch_leaves(res["batch"]), _batch_leaves(want))):
        if g.shape != w.shape or g.device != w.device or not torch.equal(g, w):
            raise AssertionError(f"sharded_resample_batch != resample_batch in leaf {i}")
    produced = want[1]

    ck = res["checkpoint"]
    for name in ("on_mesh", "on_card"):
        if not np.array_equal(ck[name], ck["ran_on"]):
            raise AssertionError(f"sharded farm restored {name} != the farm that ran on")
    if not np.array_equal(ck["ran_on"], checkpoints["want"]) or not np.array_equal(
            ck["snap"]["staging"], checkpoints["snap"]["staging"]):
        raise AssertionError("sharded farm's snapshot or continuation != the unsharded farm's")
    return dict(
        mesh=res["mesh"], tolerance="exact equality, every stream",
        farm=dict(streams=FARM["streams"], calls=len(farm["outs"]), output_shape=shape,
                  sampled_streams_vs_oracle=list(FARM["sampled"])),
        mixed=dict(streams=len(mixed["specs"]), calls=len(mixed["outs"]),
                   groups_after_adjust=res["mixed"]["groups"], moved_to=MIXED["moved_to"]),
        wide=dict(streams=WIDE_FARM["streams"], chunks=SHARDED_WIDE_CHUNKS,
                  output_shape=wide_shape),
        sharded_uniform_resample=dict(shape=list(u["out"].shape), shards=SHARD_DP),
        sharded_resample_batch=dict(
            mesh=FLEET["mesh"], streams=FLEET["streams"], n_out=FLEET["n_out"],
            taps=fleet["case"]["kw"]["max_taps"], leaves_exact=len(_batch_leaves(want)),
            produced_min_max=[int(produced.min()), int(produced.max())],
            exhausted=int(want[4].sum())),
        checkpoint=dict(saved_after_chunks=CKPT["saved_after"],
                        continued_frames=int(ck["ran_on"].shape[1]),
                        mesh_restore_exact=True, card_restore_exact=True,
                        snapshot_equals_unsharded=True),
        example=res["example"])


def host_ms(fn, reps: int = 3) -> float:
    """Best host-clock ms of fn() over ``reps`` runs after one warm-up, each
    run ended by a device synchronise (a step time, not a kernel time)."""
    fn()
    best = None
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        best = min(best or 1e30, 1e3 * (time.perf_counter() - t0))
        del out
    return best


def time_sharded(rng, farm: dict, fleet: dict) -> dict:
    """The headline farm unsharded, sharded, sharded, unsharded on the same
    chunks in fresh farms, each output held against the main path's and
    dropped (Msamples/s, ms a steady call and its split; the main path's
    farms keep every output, so past the pool's buffers each call copies
    into a fresh array), and unsharded once more with a synchronise after
    each call's staging (its ``chunk_to_card_ms``: the host part and the
    wait for the upload and the stage);
    resample_batch batched and sharded on the fleet's inputs (FLEET,
    ``fleet``), batched and looped stream by stream at BATCH; and one
    headline emit's de-interleave to a fresh host array three ways."""
    from clownresampler_tpu_torch import parallel
    from clownresampler_tpu_torch.batch import resample_batch
    from clownresampler_tpu_torch.utils import native

    mesh = shard_mesh()
    turns = []
    for name, m in (("unsharded", None), ("sharded", mesh), ("sharded", mesh),
                    ("unsharded", None), ("unsharded, the staging waited", None)):
        r = run_uniform_farm(FARM, rng, chunks=farm["chunks"], mesh=m, expect=farm["outs"],
                             wait_staging=name.endswith("waited"))
        turns.append(dict(farm=name, msamples_per_s=r["msamples_per_s"],
                          ms_per_process=r["ms_per_process"],
                          steady_split_ms=r["steady_split_ms"], ms_per_call=r["ms_per_call"]))

    args, kw = fleet["args"], fleet["kw"]
    fleet_mesh = shard_mesh(*FLEET["mesh"])
    fleet_ms = dict(
        shape={k: v for k, v in FLEET.items() if k != "replay"},
        batched_ms=host_ms(lambda: resample_batch(*args, **kw)),
        sharded_ms=host_ms(lambda: parallel.sharded_resample_batch(fleet_mesh, *args, **kw)))
    fleet_ms["sharded_over_batched"] = fleet_ms["sharded_ms"] / fleet_ms["batched_ms"]
    small = batch_case(rng)
    args, kw = small["args"], small["kw"]
    batch_ms = dict(
        shape=BATCH, batched_ms=host_ms(lambda: resample_batch(*args, **kw)),
        looped_ms=host_ms(lambda: looped_resample_batch(*args, **kw), reps=2))
    batch_ms["looped_over_batched"] = batch_ms["looped_ms"] / batch_ms["batched_ms"]

    # One headline emit: (n_out, lanes) int32 on the card to a fresh (B, n_out, C).
    n_out, b, c = HEADLINE["n_out"], FARM["streams"], FARM["channels"]
    lanes_out = torch.randint(-(1 << 20), 1 << 20, (n_out, b * c), dtype=torch.int32,
                              device=DEVICE)
    pinned = torch.empty(lanes_out.numel(), dtype=torch.int32, pin_memory=True)

    def device_transpose():   # UniformStreamFarm._to_host
        result = np.empty((b, n_out, c), np.int32)
        src = pinned.view(b, n_out, c).copy_(lanes_out.view(n_out, b, c).permute(1, 0, 2))
        torch.from_numpy(result).copy_(src)
        return result

    def torch_strided():
        result = np.empty((b, n_out, c), np.int32)
        src = pinned.view(n_out, b * c).copy_(lanes_out)
        torch.from_numpy(result).copy_(src.view(n_out, b, c).permute(1, 0, 2))
        return result

    def native_unstage():
        src = pinned.view(n_out, b * c).copy_(lanes_out)
        return native.unstage_output(src.numpy(), b, c)

    want = device_transpose()
    unstage = dict(shape=[n_out, b * c], native_available=native.available())
    for name, fn in (("device_transpose_pinned_host_copy_ms", device_transpose),
                     ("lane_major_pinned_torch_strided_copy_ms", torch_strided),
                     ("lane_major_pinned_native_unstage_ms", native_unstage)):
        if not np.array_equal(fn(), want):
            raise AssertionError(f"de-interleave {name} disagrees")
        unstage[name] = host_ms(fn, reps=5)
    return dict(farm_turns=turns, resample_batch_fleet=fleet_ms, resample_batch=batch_ms,
                deinterleave=unstage)


def batch_bound(case: dict, produced, peaks: dict) -> dict:
    """The least time the card could take for the batch call ``case``
    (batch_case) that produced ``produced``: the larger of its bytes -- each
    stream's input rows that its produced frames' windows reach, read once;
    the (B, n_out, C) int32 output written once, zeros included; the LUT and
    the per-stream leaves (ten read, four ints and a byte written) -- over
    the HBM rate, and OPS_PER_TAP operations for each live tap and channel
    of the produced frames over the int32 rate."""
    table, x, _, states, _ = case["args"]
    b, s, c = x.shape
    taps, n_out = case["kw"]["max_taps"], case["kw"]["n_out"]
    fields = np.stack([v.cpu().numpy() for v in (states.position_integer,
                                                 states.position_fractional, *states.cfg)])
    produced = produced.cpu().numpy()
    spans, live_taps, rows = {}, 0, 0
    for i in range(b):
        key = tuple(int(v) for v in fields[:, i])
        if key not in spans:
            p0, f0, radius, int_radius, delta, step, _, hi, lo = key
            t = f0 + np.arange(n_out, dtype=np.int64) * (hi * 65536 + lo)
            frac = t & 0xFFFF
            min_rel = (frac + delta + 0xFFFF) >> 16
            live = np.clip(int_radius + ((frac + radius) >> 16) - min_rel, 0, taps)
            first = p0 + (t >> 16) + min_rel
            spans[key] = (np.concatenate([[0], np.cumsum(live)]), first, first + live)
        cum, first, end = spans[key]
        k = int(produced[i])
        if k > 0:
            live_taps += int(cum[k])
            rows += min(int(end[:k].max()), s) - max(int(first[0]), 0)
    nbytes = (rows * c * x.element_size() + b * n_out * c * 4 + table.numel() * 4
              + b * (10 * 4 + 4 * 4 + 1))
    ops = OPS_PER_TAP * live_taps * c
    memory_ms = 1e3 * nbytes / peaks["hbm_bytes_per_s"]
    ops_ms = 1e3 * ops / peaks["int32_ops_per_s"]
    return dict(bound_ms=max(memory_ms, ops_ms),
                bound_by="bytes" if memory_ms >= ops_ms else "operations",
                bytes=nbytes, int32_ops=ops, memory_ms=memory_ms, operations_ms=ops_ms)


# The BATCH_CASES launch that is an oracle-scan step (B = 1, C = 2048),
# timed beside the fleet and BATCH.
ORACLE_STEP_CASE = "2-D C=2048 44.1k->8k (an oracle-scan step)"


def batch_kernel_ms(case: dict) -> float:
    """batch_mac_kernel alone on ``case`` (batch_case's keys; x (B, S, C)):
    its C entry called back to back with checked arguments into one set of
    outputs (_entry_ms), no host work between the launches."""
    from clownresampler_tpu_torch.ops import _build

    table, x, totals, states, quotas = case["args"]
    args = _build.batch_launch_args(x, table, totals, quotas, states.position_integer,
                                    states.position_fractional, states.cfg, **case["kw"])
    b, _, c = x.shape
    outs = [torch.empty((b, case["kw"]["n_out"], c), dtype=torch.int32, device=x.device),
            *torch.empty((4, b), dtype=torch.int32, device=x.device),
            torch.empty(b, dtype=torch.bool, device=x.device)]
    args.update(zip(("out", "produced", "consumed", "p_out", "f_out", "exhausted"),
                    (t.data_ptr() for t in outs)))
    return _entry_ms("crt_batch_mac", args)


def _batch_entry_timing(case: dict, call, peaks: dict, plain_reps: int = 3) -> dict:
    """One batch entry ``call`` on ``case`` (batch_case's keys; x (B, S, C))
    by CUDA events beside the kernel alone (batch_kernel_ms), its plain
    version and its bound (batch_bound)."""
    from clownresampler_tpu_torch.batch import resample_batch_reference
    from clownresampler_tpu_torch.ops import _build

    args, kw = case["args"], case["kw"]
    x = args[1]
    produced = call()[1].reshape(-1)
    res = dict(ms=cuda_ms(lambda: call()[0]), kernel_ms=batch_kernel_ms(case),
               plain_ms=cuda_ms(lambda: resample_batch_reference(*args, **kw)[0],
                                reps=plain_reps),
               library_ms=None, **batch_bound(case, produced, peaks),
               plan=_build.batch_plan(x.shape[0], kw["n_out"], x.shape[2]),
               shape=f"x {tuple(x.shape)} {x.dtype}, n_out {kw['n_out']}, "
                     f"taps {kw['max_taps']}")
    res["bound_share"] = res["bound_ms"] / res["ms"]
    return res


def oracle_step_case(gen) -> tuple:
    """(case, call) of the oracle-scan step (ORACLE_STEP_CASE): the 2-D call
    as resample_scan makes it, and its inputs as a one-stream batch for the
    bound."""
    from clownresampler_tpu_torch.batch import stack_states
    from clownresampler_tpu_torch.ops import resample as rs

    table, x, totals, state, quota, kw = batch_case_inputs(dict(BATCH_CASES)[ORACLE_STEP_CASE],
                                                          gen)
    i32 = lambda v: torch.tensor([v], dtype=torch.int32, device=x.device)
    case = dict(args=(table, x[None], i32(totals), stack_states([state]), i32(quota)), kw=kw)
    return case, lambda: rs.resample_streams(table, x, totals, state, quota, **kw)


def time_batch_kernel(fleet: dict, peaks: dict, gen) -> dict:
    """resample_batch on the fleet's inputs (FLEET): the whole entry (one
    batch_mac_kernel launch and the outputs' allocation) by CUDA events,
    beside its plain version on the card and its bound (batch_bound); the
    same at BATCH and at the oracle-scan step (ORACLE_STEP_CASE, as
    resample_streams). No single PyTorch call computes it: each tap term is
    truncated on its own (library_ms null)."""
    from clownresampler_tpu_torch.batch import resample_batch

    case = fleet["case"]
    res = _batch_entry_timing(case, lambda: resample_batch(*case["args"], **case["kw"]), peaks)
    small = batch_case(np.random.default_rng(SEED), BATCH)
    step, step_call = oracle_step_case(gen)
    res["shapes"] = dict(
        batch=_batch_entry_timing(small, lambda: resample_batch(*small["args"], **small["kw"]),
                                  peaks),
        oracle_scan_step=_batch_entry_timing(step, step_call, peaks))
    return res


def _entry_ms(entry: str, args: dict, reps: int = 20) -> float:
    """Mean device ms of the C entry ``entry`` called ``reps`` times back to
    back with checked arguments (as a farm calls it), by CUDA events, after
    an untimed pass of as many."""
    from clownresampler_tpu_torch.ops import _build

    fn, ordered = _build.entry_function(entry), _build.ordered_args(entry, args)

    def issue():
        for _ in range(reps):
            _build.raise_on_launch(fn(*ordered), entry)

    issue()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    issue()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# farm_stage_kernel is timed on these FARM_STAGE_CASES: the headline's steady
# call and its short last chunk (a long zero tail, few tiles).
STAGE_TIMING = ("headline 1024 x 2, 8916 frames, slide of 8912 parked",
                "headline short chunk of 100 in place")


def time_farm_kernels(gen, peaks: dict) -> dict:
    """farm_stage_kernel and farm_unstage_kernel at the headline farm's
    steady call (FARM_STAGE_CASES[0]; 8192 frames out), each the C entry as
    the farm calls it, beside its plain version and its bound -- the bytes it
    must move (stage: the chunk and the kept rows read, every row from 0 to
    the capacity written but the kept rows of an in-place stage; unstage:
    the emit read and written) over the HBM rate. The stage on each of
    STAGE_TIMING's cases, on the ring and on the one-tile-a-block path on the
    same inputs, each beside its own bound. The unstage also written
    straight into pinned host memory, beside the kernel into the card's
    memory followed by the download; its library call is ``copy_`` of the
    permuted view into a preallocated tensor; the stage has none (no one
    call widens, transposes, keeps rows and zeroes the tail), the ``copy_``
    of its widen-transpose part alone is a note."""
    from clownresampler_tpu_torch.farm import farm_stage_reference, farm_unstage_reference
    from clownresampler_tpu_torch.ops import _build

    dev = torch.device(DEVICE)
    rand = lambda *shape: torch.randint(-32768, 32768, shape, generator=gen, dtype=torch.int32,
                                        device=dev)
    timed = {}
    for label in STAGE_TIMING:
        _, b, c, capacity, n, keep, consumed, opts = next(
            case for case in FARM_STAGE_CASES if case[0] == label)
        lanes, in_place = b * c, opts.get("in_place", False)
        src, chunk = rand(capacity, lanes), rand(b, n, c).to(torch.int16)
        dst = src if in_place else rand(capacity, lanes)
        want_src, before = src.clone(), src.clone()
        want = want_src if in_place else torch.empty_like(dst)
        farm_stage_reference(want_src, want, chunk, keep=keep, consumed=consumed)
        args = _build.farm_stage_args(src, dst, chunk, streams=b, channels=c, n_in=n, keep=keep,
                                      consumed=consumed)
        if args["path"] != _build.FARM_STAGE_RING:
            raise AssertionError(f"{label}: the stage took path {args['path']}, not the ring")
        tile_streams, tile_frames = _build.farm_tile(c)
        nbytes = (6 * n + (0 if in_place else 8 * keep) + 4 * (capacity - keep - n)) * lanes
        bound = 1e3 * nbytes / peaks["hbm_bytes_per_s"]
        for path, launch in (("ring", args), ("one_tile_a_block", dict(
                args, path=_build.FARM_STAGE_VEC, tile_streams=tile_streams,
                tile_frames=tile_frames, stages=0, slot=0))):
            if in_place:
                dst.copy_(before)
            else:
                dst.fill_(-7)
            ms = _entry_ms("crt_farm_stage", launch)
            if not (torch.equal(dst, want) and torch.equal(src, want_src)):
                raise AssertionError(f"the timed farm_stage_kernel launches ({label}, {path}) "
                                     f"!= the plain version")
            timed[f"{label}: {path}"] = dict(ms=ms, bound_ms=bound, bound_share=bound / ms,
                                             bytes=nbytes)
        if label == STAGE_TIMING[0]:
            headline = dict(src=src, want=want, chunk=chunk, keep=keep, consumed=consumed,
                            shape=f"chunk ({b}, {n}, {c}) int16, buffers ({capacity}, {lanes}) "
                                  f"int32, keep {keep}, consumed {consumed}")
        del src, dst, want, want_src, before, chunk

    h = headline
    _, b, c, _, n, keep, _, _ = FARM_STAGE_CASES[0]
    lanes = b * c

    def plain_stage():
        farm_stage_reference(h["src"], h["want"], h["chunk"], keep=keep, consumed=h["consumed"])
        return h["want"][keep : keep + 8]

    def widen_transpose():
        h["want"][keep : keep + n].view(n, b, c).copy_(h["chunk"].permute(1, 0, 2))
        return h["want"][keep : keep + 8]

    whole = timed[f"{STAGE_TIMING[0]}: ring"]
    out = {"farm_stage_kernel": dict(
        ms=whole["ms"], plain_ms=cuda_ms(plain_stage), bound_ms=whole["bound_ms"],
        bound_by="bytes", bytes=whole["bytes"], bound_share=whole["bound_share"],
        achieved_bytes_per_s=whole["bytes"] / (whole["ms"] / 1e3), library_ms=None,
        widen_transpose_copy_ms=cuda_ms(widen_transpose), cases=timed, shape=h["shape"])}
    del h, headline

    n_out = HEADLINE["n_out"]
    emit = rand(n_out, lanes)
    device_dst = torch.empty(b * n_out * c, dtype=torch.int32, device=dev)
    pinned = torch.empty(b * n_out * c, dtype=torch.int32, pin_memory=True)
    uargs = lambda dst_ptr: _build.farm_unstage_args(emit, dst_ptr, n_out=n_out, channels=c,
                                                     stream_lo=0, streams=b)
    ms = _entry_ms("crt_farm_unstage", uargs(device_dst.data_ptr()))
    want = farm_unstage_reference(emit, n_out, c)
    if not torch.equal(device_dst.view(b, n_out, c), want):
        raise AssertionError("the timed farm_unstage_kernel launches != the plain version")
    to_pinned_ms = _entry_ms("crt_farm_unstage", uargs(pinned.data_ptr()), reps=5)
    if not torch.equal(pinned.view(b, n_out, c), want.cpu()):
        raise AssertionError("farm_unstage_kernel into pinned memory != the plain version")
    copy = dict(dst=pinned.data_ptr(), src=device_dst.data_ptr(), nbytes=device_dst.nbytes,
                device=0, stream=torch.cuda.current_stream().cuda_stream)
    download_ms = _entry_ms("crt_farm_copy", copy, reps=5)
    library = lambda: device_dst.view(b, n_out, c).copy_(emit.view(n_out, b, c).permute(1, 0, 2))
    nbytes = 2 * emit.nbytes
    bound = 1e3 * nbytes / peaks["hbm_bytes_per_s"]
    out["farm_unstage_kernel"] = dict(
        ms=ms, plain_ms=cuda_ms(lambda: farm_unstage_reference(emit, n_out, c)),
        bound_ms=bound, bound_by="bytes", bytes=nbytes, bound_share=bound / ms,
        achieved_bytes_per_s=nbytes / (ms / 1e3), library_ms=cuda_ms(library),
        into_pinned_memory_ms=to_pinned_ms, download_ms=download_ms,
        kernel_then_download_ms=ms + download_ms,
        shape=f"emit ({n_out}, {lanes}) int32 -> ({b}, {n_out}, {c})")
    return out


def copy_rates() -> dict:
    """The card's pinned copy rates both ways, at the headline call's sizes
    (one chunk up, one emit down, and the emit clamped to int16), as the
    farm issues them (cudaMemcpyAsync, CUDA events over 5 copies after 5
    untimed), and the call's bound from them."""
    f = FARM
    up = f["streams"] * f["chunk"] * f["channels"] * 2
    down = f["streams"] * HEADLINE["n_out"] * f["channels"] * 4
    host = torch.empty(max(up, down), dtype=torch.uint8, pin_memory=True)
    card = torch.empty(max(up, down), dtype=torch.uint8, device=DEVICE)
    stream = torch.cuda.current_stream().cuda_stream
    res = {}
    for name, nbytes, to_card in (("upload", up, True), ("download", down, False),
                                  ("download_s16", down // 2, False)):
        dst, src = (card, host) if to_card else (host, card)
        ms = _entry_ms("crt_farm_copy", dict(dst=dst.data_ptr(), src=src.data_ptr(),
                                             nbytes=nbytes, device=0, stream=stream), reps=5)
        res[name] = dict(bytes=nbytes, ms=ms, gbytes_per_s=nbytes / ms / 1e6)
    res["call_bound_ms"] = res["upload"]["ms"] + res["download"]["ms"]
    res["call_bound_s16_ms"] = res["upload"]["ms"] + res["download_s16"]["ms"]
    return res


def time_result_delivery() -> dict:
    """The ways a headline emit (1024 x 8192 x 2 int32, de-interleaved on the
    card) may reach a caller who owns the array, host ms a call (median of 5
    after one warm-up, each ended by the copy's completion): a pinned
    buffer that comes back when the caller drops it (the download is the
    last copy: the farm's way); a pinned scratch and a host copy into a
    fresh array (its first touch: what a caller that holds every pooled
    buffer gets) or into a recycled one (warm pages); and a newly pinned
    buffer a call."""
    b, c, n_out = FARM["streams"], FARM["channels"], HEADLINE["n_out"]
    numel = b * n_out * c
    card = torch.randint(-(1 << 20), 1 << 20, (numel,), dtype=torch.int32, device=DEVICE)
    want = card.cpu().numpy()
    scratch = torch.empty(numel, dtype=torch.int32, pin_memory=True)
    recycled = np.empty(numel, np.int32)
    recycled[:] = 0
    kept = []

    def pooled_tensor():
        scratch.copy_(card, non_blocking=True)
        torch.cuda.current_stream().synchronize()
        return scratch

    def pooled():
        return pooled_tensor().numpy()

    def fresh():
        result = np.empty(numel, np.int32)
        torch.from_numpy(result).copy_(pooled_tensor())
        return result

    def into_recycled():
        torch.from_numpy(recycled).copy_(pooled_tensor())
        return recycled

    def newly_pinned():
        kept.append(torch.empty(numel, dtype=torch.int32, pin_memory=True))
        kept[-1].copy_(card, non_blocking=True)
        torch.cuda.current_stream().synchronize()
        return kept[-1].numpy()

    res = dict(shape=[b, n_out, c], bytes=4 * numel)
    for name, fn in (("pinned_buffer_reused_ms", pooled),
                     ("pinned_scratch_then_fresh_array_ms", fresh),
                     ("pinned_scratch_then_recycled_array_ms", into_recycled),
                     ("newly_pinned_buffer_a_call_ms", newly_pinned)):
        times = []
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = fn()
            times.append(1e3 * (time.perf_counter() - t0))
            if not np.array_equal(got, want):
                raise AssertionError(f"result delivery {name} disagrees")
            del got
        res[name] = statistics.median(times[1:])
        res[name[:-3] + "_first_ms"] = times[0]
    return res


# ROUTES kind -> the kernels one launch of it puts on the card.
ROUTE_KERNELS = {"farm_stage": ("farm_stage_kernel",), "farm_unstage": ("farm_unstage_kernel",),
                 **ENTRY_KERNELS}


def host_stage_uploads(farm, n: int) -> int:
    """The uploads a call of ``n`` frames issues through crt_farm_host_stage
    on each of ``farm``'s programs (a UniformStreamFarm's): its pieces."""
    from clownresampler_tpu_torch.ops import _build

    return sum(len(_build.farm_host_pieces(2 * (hi - lo) * n * farm.channels))
               for _, lo, hi, _ in farm._programs)


def profile_farm_call(label: str, call, programs: int, uploads: int,
                      attempts: int = 3) -> dict:
    """One steady farm call (``call()``, after the farm has run a few) under
    torch.profiler. It fails unless the card ran ``uploads`` host-to-device
    copies (the pieces of the chunk, host_stage_uploads), and for each of the
    farm's ``programs`` FarmPrograms one farm_stage_kernel, one
    farm_unstage_kernel and one download, the kernels of the launches that
    ROUTES counted during the call, and nothing else; and unless the call ran
    no ``aten::`` op at all (the chunk reaches the pinned input through the
    farm library's host threads); the recorder's record_function ranges
    (``utils.profiling.RANGES``) are neither. A count that is off is taken again (the
    profiler now and then loses a record), up to ``attempts`` times. Returns
    the activities, their device ms and the call's profiled wall ms."""
    from clownresampler_tpu_torch.ops.resample import ROUTES
    from clownresampler_tpu_torch.utils import profiling

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for attempt in range(1, attempts + 1):
        torch.cuda.synchronize()
        before = dict(ROUTES)
        with torch.profiler.profile(activities=acts) as prof:
            torch.cuda.synchronize()  # the tracer is up before the first launch
            t0 = time.perf_counter()
            call()
            wall_ms = 1e3 * (time.perf_counter() - t0)
            torch.cuda.synchronize()
        want = {"Memcpy HtoD": uploads, "Memcpy DtoH": programs}
        for (kind, impl), count in ROUTES.items():
            launched = count - before.get((kind, impl), 0)
            if kind == "farm_input":
                continue
            for kernel in ROUTE_KERNELS[kind] if launched and impl == "cuda" else ():
                want[kernel] = want.get(kernel, 0) + launched
        if (want.get("farm_stage_kernel"), want.get("farm_unstage_kernel")) != (programs,) * 2:
            raise AssertionError(f"{label}: ROUTES counted {want} for {programs} programs")
        counts, device_us, aten = {}, {}, set()
        for evt in prof.events():
            if evt.name in profiling.RANGES:  # the recorder's ranges, on the host and the card
                continue
            if evt.device_type == torch.autograd.DeviceType.CUDA:
                name = next((k for k in want if k in evt.name), evt.name)
                counts[name] = counts.get(name, 0) + 1
                device_us[name] = device_us.get(name, 0) + evt.time_range.elapsed_us()
            elif evt.name.startswith("aten::"):
                aten.add(evt.name)
        strangers = [k for k in counts if k not in want]
        if strangers:
            raise AssertionError(f"{label}: a steady farm call put {strangers} on the card")
        if counts == want:
            break
        if attempt == attempts:
            raise AssertionError(f"{label}: device activities {counts} in each of {attempts} "
                                 f"profiles, wanted {want}")
    if aten:
        raise AssertionError(f"{label}: a steady farm call ran aten ops {sorted(aten)}")
    total_us = sum(device_us.values())
    return dict(farm=label, aten_ops=0, profiles_taken=attempt,
                device_activities=counts, device_ms={k: v / 1e3 for k, v in device_us.items()},
                device_ms_total=total_us / 1e3, profiled_wall_ms=wall_ms,
                profiled_device_busy_share=total_us / 1e3 / wall_ms)


def profile_farms(rng, farm: dict) -> list:
    """Steady calls under torch.profiler (profile_farm_call): the headline
    farm unsharded and on shard_mesh(), and the config-5 mixed farm (four
    groups: three tiled -- 8 kHz -> 48 kHz in four launches a call --, one
    strided), each after three unprofiled calls."""
    import clownresampler_tpu_torch as crt
    from clownresampler_tpu_torch.parallel import ShardedStreamFarm

    f, m = FARM, MIXED
    chunks = farm["chunks"]
    res = []
    for label, fm, programs in (
            ("headline", crt.UniformStreamFarm(f["streams"], f["channels"], *f["rates"],
                                               chunk_frames=f["chunk"], device=DEVICE), 1),
            ("headline sharded", ShardedStreamFarm(shard_mesh(), f["streams"], f["channels"],
                                                   *f["rates"], chunk_frames=f["chunk"]),
             SHARD_DP)):
        for chunk in chunks[:3]:
            fm.process(chunk)
        res.append(profile_farm_call(label, lambda: fm.process(chunks[3]), programs,
                                     host_stage_uploads(fm, chunks[3].shape[1])))
        del fm
    specs = [rates for rates in m["groups"] for _ in range(m["per_group"])]
    mixed = crt.MixedStreamFarm(specs, m["channels"], chunk_frames=m["chunk"],
                                max_radius=m["max_radius"], device=DEVICE)
    mchunks = [list(rng.integers(-32768, 32768, size=(len(specs), m["chunk"], m["channels"]),
                                 dtype=np.int16)) for _ in range(2)]
    for k in range(3):
        mixed.process(mchunks[k % 2])
    uploads = sum(host_stage_uploads(group, m["chunk"]) for group, _ in mixed._groups)
    res.append(profile_farm_call("mixed (config 5)", lambda: mixed.process(mchunks[1]),
                                 len(m["groups"]), uploads))
    return res


def run_cli() -> dict:
    """The CLI on the fixture PCM written as a WAV, on the card, and
    resample_array on the card on the same input (main path)."""
    import contextlib
    import io
    import tempfile

    import clownresampler_tpu_torch as crt
    from clownresampler_tpu_torch.__main__ import main as cli_main
    from clownresampler_tpu_torch.utils.audio_io import read_raw_s16le, read_wav, write_wav

    pcm = read_raw_s16le(PCM, channels=2)
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = os.path.join(tmp, "in.wav"), os.path.join(tmp, "out.wav")
        write_wav(src, pcm, CLI_RATES[0])
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            rc = cli_main([src, dst, str(CLI_RATES[1]), "--device", DEVICE])
        if rc != 0:
            raise AssertionError(f"CLI exited {rc}")
        written, rate = read_wav(dst)
    wide = crt.resample_array(pcm, *CLI_RATES, CLI_RATES[1], device=DEVICE)
    return dict(written=written, rate=rate, wide=wide, printed=printed.getvalue().strip())


def check_cli(res: dict) -> dict:
    from clownresampler_tpu_torch.utils.audio_io import clamp_s16

    md5 = hashlib.md5(np.asarray(res["wide"], dtype="<i4").tobytes()).hexdigest()
    want = next(g[3] for g in GOLDENS if g[:3] == (*CLI_RATES, CLI_RATES[1]))
    if md5 != want:
        raise AssertionError(f"resample_array {CLI_RATES}: md5 {md5}")
    if res["rate"] != CLI_RATES[1] or res["written"].tobytes() != clamp_s16(res["wide"]).tobytes():
        raise AssertionError("CLI output != s16 clamp of resample_array on the card")
    return dict(rates=CLI_RATES, device=DEVICE, frames=int(res["written"].shape[0]),
                md5_s32le=md5, printed=res["printed"])


def _read(path: str) -> str:
    try:
        with open(path) as f:
            return f.read().strip()
    except OSError as e:
        return f"unreadable: {e}"


def host_facts() -> dict:
    """What bounds a farm call's host half (PERF.md §5): torch's thread
    count, the CPUs this process may use, the card's NUMA node and its CPUs,
    the machine's nodes, transparent huge pages."""
    import glob

    p = torch.cuda.get_device_properties(0)
    ids = [getattr(p, k, None) for k in ("pci_domain_id", "pci_bus_id", "pci_device_id")]
    pci = None if None in ids else "/sys/bus/pci/devices/{:04x}:{:02x}:{:02x}.0".format(*ids)
    return dict(
        torch_threads=torch.get_num_threads(), os_cpu_count=os.cpu_count(),
        affinity_cpus=len(os.sched_getaffinity(0)),
        card_numa_node=_read(os.path.join(pci, "numa_node")) if pci else None,
        card_local_cpus=_read(os.path.join(pci, "local_cpulist")) if pci else None,
        numa_nodes={os.path.basename(d): _read(os.path.join(d, "cpulist"))
                    for d in sorted(glob.glob("/sys/devices/system/node/node[0-9]*"))},
        thp_enabled=_read("/sys/kernel/mm/transparent_hugepage/enabled"),
        thp_defrag=_read("/sys/kernel/mm/transparent_hugepage/defrag"))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one card", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    phase("environment", torch=torch.__version__, cuda=torch.version.cuda,
          device=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
          nvidia_smi=smi)
    phase("host", **host_facts())

    from clownresampler_tpu_torch.ops import _build
    from clownresampler_tpu_torch.ops.resample import ROUTES

    _build.library("resample")
    usage = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "Compiling entry" in ln]
             for name, log in _build.BUILD_LOG["ptxas"].items()}
    phase("build", seconds=round(_build.BUILD_LOG["seconds"], 3),
          libraries={k: os.path.relpath(v, ROOT) for k, v in _build.BUILD_LOG["paths"].items()},
          ptxas=usage)

    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    checks = check_kernels(gen)
    phase("kernels_vs_plain", tolerance="exact equality", cases=checks)

    # The main paths: reset the launch counts, drive the public entry points,
    # read the counts; the outputs are checked afterwards (the checks' own
    # launches are not counted).
    ROUTES.clear()
    goldens = run_goldens()
    farm = run_uniform_farm(FARM, rng)
    strided = run_uniform_farm(STRIDED_FARM, rng)
    mixed = run_mixed_farm(rng)
    wide = run_wide_paths(rng)
    scans = run_scans(gen)
    checkpoints = run_checkpoints(rng)
    cli = run_cli()
    fleet = run_fleet_batch(rng)
    torch.cuda.synchronize()
    launches = dict(ROUTES)
    # The sharded paths, counted apart from the paths above.
    ROUTES.clear()
    sharded = run_sharded_paths(rng, gen, farm, mixed, checkpoints, fleet)
    torch.cuda.synchronize()
    sharded_launches = dict(ROUTES)
    phase("routes", launches={f"{k}/{impl}": v for (k, impl), v in sorted(launches.items())},
          sharded_launches={f"{k}/{impl}": v
                            for (k, impl), v in sorted(sharded_launches.items())})
    for name, counts, names in (("main", launches, KERNELS),
                                ("sharded", sharded_launches, SHARDED_KERNELS)):
        kernel_routes = {k for k in counts if k[0] != "farm_input"}
        if kernel_routes != {(KERNELS[kernel][0], "cuda") for kernel in names}:
            raise AssertionError(f"{name} paths took routes other than their kernels: "
                                 f"{counts}")
        # Every farm of these paths took its chunks straight from the caller's
        # int16 arrays (uniform farms) or stacked them (mixed farms).
        if set(input_routes(counts)) != {"direct", "stacked"}:
            raise AssertionError(f"{name} paths' farms took the input routes "
                                 f"{input_routes(counts)}")
    phase("farm_input_routes", main=input_routes(launches),
          sharded=input_routes(sharded_launches), **run_input_routes(farm))

    phase("goldens", passed=goldens, md5_ok=True)
    for name, spec, res in (("farm", FARM, farm), ("strided_farm", STRIDED_FARM, strided)):
        shape = check_uniform_farm(spec, res)
        phase(name, streams=spec["streams"], channels=spec["channels"], rates=spec["rates"],
              chunk_frames=spec["chunk"], frames_per_process=res["frames"],
              sampled_streams_exact=list(spec["sampled"]), output_shape=shape,
              msamples_per_s=res["msamples_per_s"], ms_per_process=res["ms_per_process"],
              steady_split_ms=res["steady_split_ms"], ms_per_call=res["ms_per_call"])
    phase("mixed_farm", groups=MIXED["groups"], streams_per_group=MIXED["per_group"],
          chunk_frames=MIXED["chunk"], moved_to=MIXED["moved_to"], **check_mixed_farm(mixed),
          msamples_per_s=mixed["msamples_per_s"], ms_per_process=mixed["ms_per_process"],
          ms_per_call=mixed["ms_per_call"])
    want = oracle_stream(wide["pcm"], *WIDE_FARM["rates"])
    if not np.array_equal(wide["array_out"], want):
        raise AssertionError("resample_array 44.1k->132 != gather oracle")
    for rates, got in wide["general"].items():
        if not np.array_equal(got, oracle_stream(wide["pcm"], *rates)):
            raise AssertionError(f"resample_array {rates[0]}->{rates[1]} != gather oracle")
    shape = check_uniform_farm(WIDE_FARM, wide["farm"])
    phase("wide", resample_array_frames=int(want.shape[0]), resample_array_exact=True,
          general_ratio_arrays_exact=[f"{a}->{b}" for a, b in GENERAL_WIDE_RATES],
          farm_streams=WIDE_FARM["streams"], farm_chunk_frames=WIDE_FARM["chunk"],
          farm_sampled_streams_exact=list(WIDE_FARM["sampled"]), farm_output_shape=shape,
          farm_msamples_per_s=wide["farm"]["msamples_per_s"],
          farm_ms_per_process=wide["farm"]["ms_per_process"],
          farm_ms_per_call=wide["farm"]["ms_per_call"])
    config7 = scans.pop(SCAN7["rates"])
    phase("scan_config7", streams=SCAN7["lanes"] // 2, sync_debug_mode="error",
          **check_scan(config7), replayed_streams_exact=check_scan_replay(config7, SCAN7["replay"]))
    phase("scan_engines", sync_debug_mode="error", runs=[check_scan(run) for run in scans.values()])
    del config7, scans
    phase("checkpoint", **check_checkpoints(checkpoints))
    phase("cli", **check_cli(cli))
    phase("fleet_batch", **check_fleet_batch(fleet))
    phase("sharded", **check_sharded_paths(sharded, farm, mixed, checkpoints, fleet, rng),
          nvidia_smi=smi,
          farms={name: dict(msamples_per_s=sharded[name]["msamples_per_s"],
                            ms_per_process=sharded[name]["ms_per_process"],
                            ms_per_call=sharded[name]["ms_per_call"],
                            steady_split_ms=sharded[name].get("steady_split_ms"))
                 for name in ("farm", "mixed", "wide")},
          unsharded_farms={name: dict(msamples_per_s=r["msamples_per_s"],
                                      ms_per_process=r["ms_per_process"],
                                      steady_split_ms=r.get("steady_split_ms"))
                           for name, r in (("farm", farm), ("mixed", mixed),
                                           ("wide", wide["farm"]))})
    del checkpoints, cli, sharded, mixed, strided, wide

    timing = time_kernels(gen)
    phase("timing", nvidia_smi=smi, **timing)
    farm_kernels = time_farm_kernels(gen, timing["peaks"])
    timing["kernels"].update(farm_kernels)
    phase("farm_kernels", nvidia_smi=smi, **farm_kernels)
    phase("copy_rates", nvidia_smi=smi, **copy_rates())
    phase("result_delivery", nvidia_smi=smi, **time_result_delivery())
    batch_kernel = time_batch_kernel(fleet, timing["peaks"], gen)
    timing["kernels"]["batch_mac_kernel"] = batch_kernel
    phase("batch_kernel", nvidia_smi=smi, **batch_kernel)
    sharded_timing = time_sharded(rng, farm, fleet["case"])
    phase("sharded_timing", nvidia_smi=smi, **sharded_timing)
    farm = dict(chunks=farm["chunks"])
    del fleet
    scan_timing = time_scan(gen, timing["peaks"])
    phase("scan_timing", nvidia_smi=smi, **scan_timing)
    phase("entry_launches", nvidia_smi=smi, **count_entry_launches(gen))
    modes = scan_timing["scan_modes"]
    timing["kernels"].update({"tiled_mac_kernel/scan": modes["config7"],
                              "strided_mac_kernel/scan": modes["strided"],
                              "wide_mac_kernel/scan": modes["wide"]})
    # A steady farm call under the profiler, beside the unprofiled calls' time.
    profiles = profile_farms(rng, farm)
    steady_ms = statistics.median(t["ms_per_process"] for t in sharded_timing["farm_turns"]
                                  if t["farm"] == "unsharded")
    phase("farm_profiles", nvidia_smi=smi, calls=profiles,
          headline_steady_call_ms=steady_ms,
          headline_device_idle_share=1 - profiles[0]["device_ms_total"] / steady_ms)

    kernels = []
    for name, (kind, source, replaces) in KERNELS.items():
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches.get((kind, "cuda"), 0),
            sharded_launches=sharded_launches.get((kind, "cuda"), 0),
            max_abs_err=max(err for _, err in checks[name]),
            ms=timing["kernels"][name]["ms"], plain_ms=timing["kernels"][name]["plain_ms"],
            bound_ms=timing["kernels"][name]["bound_ms"],
            bound_by=timing["kernels"][name]["bound_by"],
            # No single PyTorch call computes the MAC launches, the scan modes
            # included (each tap term is truncated on its own), or the farm's
            # stage (a widen, a transpose, kept rows and a zero tail); the
            # unstage has ``copy_`` of the permuted view (PERF.md).
            library_ms=timing["kernels"][name].get("library_ms")))
        if kernels[-1]["launches"] < 1 or (
                name in SHARDED_KERNELS and kernels[-1]["sharded_launches"] < 1):
            raise AssertionError(f"{name} was not launched on the main or the sharded paths")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
