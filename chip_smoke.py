"""Drive chiaswarm_tpu_torch on one NVIDIA H100 and check it end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is printed as a result then):

1. Device probe: CUDA present, compute capability 9.0, and the card's
   name and power limit from nvidia-smi.
2. Kernel build: every source under chiaswarm_tpu_torch/csrc, one nvcc
   each, in parallel; the build is timed.
3. Kernels against their plain PyTorch versions at the shapes of the SDXL
   1024^2 main path, bf16 and f32, each within its stated bound; and
   attention at the edges of the kernels' tiles: query and KV lengths
   that are not multiples of a tile (Sq 1000 against Skv 77, 1000 and
   4095), a query shorter than one tile (Sq 40), and B*H > 1 at D = 512.
   GroupNorm at the edges of its launch plan: rows that do not divide
   among the CTAs, B = 1 against B = 2 at the same N*C, groups that
   straddle an 8-channel vector (C = 320), every main-path call too large
   to stay on chip in bf16 and f32, eps 1e-6, a mean ten times the spread
   (held against the plain version evaluated in float64), and one input
   run 20 times with bit-identical outputs. The VAE encoder's calls that
   the decoder never makes, (1,512,512,128) and (1,256,256,256), and its
   attention, in bf16 and f32. Every attention and GroupNorm shape of the
   SD 1.x 512^2 and SD 2.x 768^2 UNet calls and of their VAE at those
   canvases (attention in bf16 and f32), and the tile edges at D = 40, 80
   and 160 (Sq 1000 against Skv 77, 1000 and 4095, Sq 40, B*H of 1). Every
   attention and GroupNorm shape of an SD 1.5 pix2pix UNet call at 512^2
   and an SDXL pix2pix one at 768^2 (3 CFG rows) and of an SDXL refiner
   UNet call at 1024^2 (GroupNorm at C = 384 to 3072), in bf16 and f32.
   Every bf16 attention call at D = 40, 64, 80, 160 or 512 must report the
   tensor-core route, not the FMA kernel. The upscale path's shapes
   (`upscale_checks`): the safety checker's (B, 257, 16, 64), the K-UNet's
   attention on the 2x latents of SD 1.5 and SDXL jobs, the upscaler
   VAE's (1, 65536, 1, 512) (the plain version over query chunks, every
   row against all keys) and GroupNorm up to (1, 2048, 2048, 256), in
   bf16 and f32. DPT-large's attention, (1, 577, 16, 64) in bf16 and f32
   (`preprocessor_checks`; 577 rows leave the last Q and KV tiles
   ragged), bf16 on the tensor-core route. Flux's joint attention at
   D = 128 (`flux_checks`): (1, 4608, 24, 128), (1, 4352, 24, 128),
   (2, 2816, 24, 128) and a coalesced (4, 4608, 24, 128) in bf16 and f32,
   and the D = 128 tile edges; every bf16 call on `wgmma-d128`.
   Kandinsky's (`kandinsky_checks`): every attention and GroupNorm call of
   a 2.2 and a 2.1 decoder UNet call (two CFG rows; keys 32 or 10 + 77
   conditioning tokens ahead of the self tokens) and of a MoVQ decode and
   encode (one head of 512; norms at eps 1e-6 up to (1, 768, 768, 128)),
   at 512^2 and 768^2, in bf16 and f32; bf16 on `wgmma-d64` / `wgmma-d512`.
   Kandinsky 3's (`kandinsky3_checks`): the GroupNorm of a UNet call at
   1024^2 (C = 192 in groups of 6 channels) and every call of a MoVQ
   decode and encode at 1024^2 (one head of 512 over 16384 tokens); Stable
   Cascade's (`cascade_checks`): every attention call of a stage C call
   (576 queries over 576 + 85 keys, 32 heads of 64) and a stage B call
   (1024 and 256 queries over themselves and 4 pooled-text tokens, 20
   heads of 64) at 1024^2; bf16 and f32, bf16 on the tensor-core routes.
4. Small-input reference: the tiny SDXL-shaped pipeline in f32 on the card
   (kernels) against the same weights and latents on the CPU (plain
   versions); the decoded uint8 images must agree within 2/255. At 64^2:
   tiny-xl img2img, 4-channel inpaint and test/tiny-xl-inpaint (9
   channels), and one 4-step inpaint job for every SD solver wire
   name, with the same injected noise on both sides. For 4-channel
   inpaint on the card, the latents that reach the decode must equal the
   encoded clean latents bit for bit where the mask keeps the image.
   test/tiny-sd (SD 1.x / 2.x structure) and a tiny SD model whose
   scheduler config says v_prediction, card against CPU within 2/255.
   Then the tiny models' weights written as safetensors (test/tiny-sd's in
   the legacy layout: 1x1-conv proj_in, the VAE's query/key/value/proj_attn,
   position_ids, a spare CLIP layer) and served from there by a Registry on
   the card (f32) and one on the CPU: test/tiny-pix2pix and
   test/tiny-xl-pix2pix pix2pix jobs, test/tiny-xl with test/tiny-xl-refiner
   chained, test/tiny-sd txt2img; each must report weights loaded from the
   checkpoint, and the images agree within 2/255. Then adapters written
   from seeded tensors, card against CPU within 2/255, each image moved by
   its adapter: test/tiny-xl with a kohya LoRA over the UNet and both text
   encoders (`.alpha` per module) at scale 0.8 given as
   cross_attention_kwargs.scale; test/tiny-sd with a PEFT LoRA whose
   proj_in / proj_out factors are 1x1 convs (skipped, the same count on both
   devices); a dual-encoder and a diffusers textual inversion; a custom VAE
   on a tiny-sd img2img job. test/tiny-flux and test/tiny-flux-schnell
   (`tiny_flux_checks`), written as diffusers safetensors and loaded from
   them, card (f32, kernels) against CPU (plain) within 2/255, a job of two
   images and a coalesced pass of two. Kandinsky (`tiny_kandinsky_checks`):
   the tiny 2.2 decoder (txt2img, img2img), the tiny depth ControlNet (a
   768^2 hint) with their tiny prior, and a tiny 2.1 decoder (MCLIP, a
   tokenizer.json), written as diffusers safetensors and loaded from them,
   card (f32) against CPU within 2/255 with every draw injected alike.
5. Main path: a fake hive on localhost, the port's worker, and the
   full-width stabilityai/stable-diffusion-xl-base-1.0 pipeline on seeded
   random weights; three 1024^2 30-step DPM++ 2M txt2img jobs and one echo
   job are served. Every envelope is checked (sha256 of the artifact, a
   decodable image that is not constant, finite latents). The kernels'
   launch counts are reset just before and read just after.
   Then the image path: the counts are reset again, the 9-channel
   diffusers/stable-diffusion-xl-1.0-inpainting-0.1 is built beside the
   base model, and three 1024^2 30-step jobs whose start image (a smooth
   JPEG under the 3 MiB input cap) and half mask the fake hive serves:
   img2img (strength 0.75, Euler ancestral), 4-channel inpaint (strength
   1.0, DDIM) and 9-channel inpaint (UniPC). Each envelope is checked as
   above and for its mode; each job's launches are counted and held to
   its UNet calls times the UNet's launches per call (from the txt2img
   jobs) plus one VAE encode and one decode.
   Then the SD path, counted the same way (32 attention and 61 GroupNorm
   launches per UNet call): runwayml/stable-diffusion-v1-5 txt2img (DPM++
   2M) and img2img (Euler ancestral, strength 0.75) at 512^2, the
   9-channel runwayml/stable-diffusion-inpainting (UniPC) at 512^2, and
   stabilityai/stable-diffusion-2-1 txt2img at 768^2 with v-prediction
   (DPM++ 2M), all 30 steps on seeded random weights, in a registry of
   their own. Then the edit path, counted the same way: timbrooks/instruct-
   pix2pix at 512^2 and diffusers/sdxl-instructpix2pix-768 at 768^2 from the
   fake hive's start image at strength 0.3 (image guidance 1.5, 30 UNet
   calls of 3 CFG rows), and an SDXL base txt2img job at 1024^2 with
   stabilityai/stable-diffusion-xl-refiner-1.0 chained (strength 0.3: 9
   refiner UNet calls of 88 attention and 56 GroupNorm launches, and the
   refiner's encode and decode). Then the checkpoint path: SD 1.5's seeded
   full-width weights written as fp16 safetensors in diffusers layout (SD
   1.x's 1x1-conv proj_in / proj_out) under a temporary model root, one
   512^2 txt2img job served through the worker's Registry over that root
   (load time and bytes read printed), its image equal bit for bit to the
   same job on a pipeline given the same fp16 tensors through `weights=`;
   then four tiny models fill the registry, the fifth evicts SD 1.5 (the
   least recently used), the device's allocated memory must fall by SD
   1.5's bytes less the tiny model's (within 10% of SD 1.5's), and a second
   job rebuilds SD 1.5 from its files with the first job's image bit for
   bit. Then the adapter path (`serve_adapter_path`), in a registry of its
   own over a temporary root where every adapter is written from seeded
   tensors: SDXL 1024^2 30-step DPM++ 2M txt2img plain, with a rank-32
   kohya LoRA over 722 UNet and 264 text-encoder modules at scale 0.8, with
   it at scale 0, plain again, and with a dual-encoder textual inversion
   and a custom VAE; SD 1.5 512^2 under LCMScheduler at 4 steps plain and
   with a rank-64 PEFT LoRA (160 modules, its 32 conv-shaped factors
   skipped), and 30 steps plain and with a textual inversion and a custom
   VAE. Each adapter job launches exactly what its plain twin does; scale 0
   and the plain job after the LoRA job give the plain image bit for bit;
   the LoRA changes it. The adapters' load times and bytes are printed,
   the delta's device time per UNet call is a profiler category of its own
   (SDXL and SD 1.5), one bf16 SDXL UNet call with the delta is held to
   phase 7's bound, and evicting SDXL must free its adapter stacks (and
   the device memory of its weights, stacks, table and VAE). Then the
   batched path (`serve_batched_path`: coalesced SDXL and SD 1.5 passes,
   each beside the same jobs served alone, at BATCHED_STEPS). Then the ControlNet path
   (`serve_controlnet_path`), in a registry of its own over a temporary
   root where three ControlNets are written from seeded tensors, every
   conv nonzero, at the published configs of
   lllyasviel/control_v11p_sd15_canny, monster-labs/
   control_v1p_sd15_qrcode_monster and diffusers/controlnet-canny-sdxl-1.0:
   SD 1.5 512^2 txt2img plain, with the canny preprocessor on a served
   photo-like image, the same at scale 0 and with a zero-init branch (both
   the plain image bit for bit), with the window 0.25-0.75 (16 branch
   calls), img2img (0.75) and 4-channel inpaint with a control image; the
   QR two-stage chain at 768^2 (the QR image served as the control image);
   SDXL 1024^2 txt2img; four SDXL jobs sharing one ControlNet and control
   image as one pass, and each alone. Launches are held to the UNet calls
   plus the branch calls (14 attention and 27 GroupNorm a call for SD 1.x,
   68 and 21 for SDXL); one bf16 ControlNet call of each model is held to
   phase 7's bound and profiled; evicting SDXL must free its ControlNet's
   device memory with it. No served bf16 attention may take the FMA
   kernel. Then the upscale and safety path (`serve_upscale_path`), in a
   registry of its own over a temporary root where the SD-x2 upscaler
   and the safety checker are written from seeded tensors at their
   published widths and layouts: the checker called once directly (its
   bf16 concept scores within SCORE_TOL of the f32 plain path's), then
   SD 1.5 512^2 and SDXL 1024^2 txt2img plain and with `upscale`, a
   standalone StableDiffusionLatentUpscalePipeline job and, once the
   upscaler's folder is removed and the pipeline evicted, the
   latent-resize fallback; every envelope `nsfw_checked`, 2x images,
   launches held to the UNet calls, 20 K-UNet calls x 32 attention, the
   upscaler's encode and decode and one checker call (24 attention); one
   bf16 K-UNet call against f32 on the plain path, and the checker, the
   K-UNet at both canvases and the 1024^2 and 2048^2 decodes profiled.
   Then the preprocessor path (`serve_preprocessor_path`), in a registry
   of its own over a temporary root where every detector of the
   ControlNet preprocessors is written from seeded tensors at its
   published widths and in its published layout (DPT-large, HED, the
   openpose body network, PiDiNet, M-LSD, LineArt, ZoeDepth, UperNet
   ConvNeXt-small) beside the depth ControlNets of SD 1.5 and SDXL: each
   detector alone (load seconds and bytes, resident bytes, device ms and
   attention launches a call, its bf16 output through the kernels
   against f32 on the plain path within E2E_RATIO x the plain bf16
   path's error); one SD 1.5 512^2 ControlNet job per preprocessor name
   and a plain one, launches held to the plain job's plus the
   detector's (24 attention launches for DPT); an SDXL 1024^2 depth job;
   a stitch job; then a degraded root: a depth job without DPT ends in a
   fatal envelope, scribble without HED is served by the Laplacian
   unflagged, mlsd, lineart, segmentation and (DPT back) zoe depth by
   their stand-ins with `degraded_preprocessors`, and M-LSD's file put
   back serves the next mlsd job (the mtime negative cache).
   Then the resume and cancel path (`serve_resume_path`), in the main
   path's registries, through workers with `denoise_chunk_steps` 5: an
   SDXL 1024^2 30-step DPM++ 2M job with a checkpoint every 2 chunk
   boundaries and a preview at every one, against the same job with
   chunking off and chunked with nothing armed (bit for bit; checkpoints at steps 10 and 20, previews at
   5 to 25, each a 1024^2 JPEG; the blob's bytes printed); the job
   redelivered with the hive's step-20 resume offer (bit for bit,
   `resumed` {20, 10}) and with the checkpoint repacked under a wrong
   program signature (the full pass, bit for bit); SD 1.5 512^2 under
   Euler ancestral resumed at step 20 against the undisturbed job (bit
   for bit: the generator's state travels in the blob); an SDXL job the
   fake hive cancels after its first preview (no envelope, the device
   free within one chunk of the cancel reaching the worker, both times
   printed, and the next job served); a coalesced chunked pass of four
   SDXL jobs at BATCHED_STEPS, the same four with one cancelled mid-pass
   (three envelopes, bit for bit those of the first pass) and with all
   four cancelled (no envelope). Launches are held to the UNet calls plus
   one decode and one decode a preview.
   Then the worker-plane path (`serve_worker_plane_path`), in the main
   path's registries, through workers with the metrics app on, under a
   $SDAAS_ROOT of its own: an SDXL 1024^2 30-step job with /metrics and
   /healthz scraped during and after its pass (`cost.flops` the analytic
   count of models/flops.py, `mfu` in (0, 1] against the H100's 989.4
   TFLOP/s and equal to `swarm_pass_mfu`, the pass ledger's divergence
   ratio within 5% of 1, launches as the main path's job), an SD 1.5
   512^2 job's MFU, the outbox's write of the envelope timed; then SDXL
   under `drop_submit=2` (delivered after two retries), under
   `kill_before_ack=1` (a new worker on the same root redelivers the
   envelope byte for byte), refused with a 422 (parked on disk); SD 1.5
   under `hang_denoise=1` with a 3 s deadline (the transient envelope,
   /healthz 503 while quarantined, the probe's matmul on the card once
   the hung pass ends, the next job served); SIGTERM 0.5 s into an SDXL
   pass (its envelope delivered before `run` returns, nothing taken
   after); a 2 s `/debug/profile` capture during an SDXL pass, whose
   Chrome trace holds `flash_fwd_wgmma` and `gn_fused` kernels.
   Then the hive-plane path (`serve_hive_plane_path`), in a registry of
   its own that shares the main path's SDXL and SD 1.5 pipelines and reads
   the SD-x2 upscaler and the safety checker from seeded files, through
   workers and fake hives under a $SDAAS_ROOT of its own: four SDXL
   1024^2 15-step jobs handed as one gang (one pass, flush "gang", the
   trace echoed) and again coalesced by the linger, bit for bit the same
   pixels; nine SD 1.5 512^2 jobs as one gang, passes of 8 and 1; an SD
   1.5 30-step job whose primary answers /results with 409 and epoch 2,
   delivered on the standby (the epoch echoed and persisted, nothing
   parked), then the standby dark and a second job served on the primary
   after two failed polls (two failovers); an SDXL 30-step workflow
   (encode / denoise / decode) equal bit for bit to the monolithic job
   with the same launches; an SD 1.5 workflow with `upscale` (the
   upscaler's input rows equal the monolithic image bit for bit, its
   output equal to a direct call with the stage's seed, and within
   UPSCALE_SPREAD_RATIO of the upscaler's two-seed spread of the
   monolithic upscale job); two SDXL workflows back to back, the first's
   decode (the checker on the card, from the stage lane) inside the
   second's pass; the `stats` EWMAs and the lane's gauge back at 0.
   Launches held per job kind with one checker call a job.
   The Kandinsky path (`serve_kandinsky_path`), its own registry beside
   the main path's SDXL pipelines: the published 2.2 prior, decoder and
   depth ControlNet and 2.1's decoder (MCLIP) and prior written from
   seeded tensors as bf16 diffusers safetensors and loaded from them (the
   2.2 prior with zero_image_embed.npy, 2.1's without), the 2.2 pair's
   allocated bytes printed; 2.2 txt2img at 512^2 and 768^2, img2img at
   strength 0.75, the ControlNet at 768^2 with its hint from DPT-large,
   2.1 at 512^2, 30 DDPM steps and 25 prior steps each, through the
   worker; every envelope checked as the Flux path's, launches held to
   the prediction from the configs' arithmetic (`kandinsky_calls`), in
   total and shape by shape; the 2.1 decoder's parameters printed beside
   the bytes the registry reckons; one decoder UNet call and one MoVQ
   decode profiled.
   After phase 8, Flux joins the main path's registry while its SDXL
   pipelines, the SD registry, the detectors and the checker are still
   resident (`serve_flux_beside_sd`): one FLUX.1-schnell 4-step job, the
   SDXL base staying resident; then one FLUX.1-dev 4-step job, whose
   bundle is larger than the free memory before its build, so the build
   succeeds only because the registry evicts least recently used
   pipelines by bytes first. Allocated and free memory and the resident
   models are printed before and after each; launches held as below.
   The Flux path (`serve_flux_path`) runs next, once the SD
   registries, the detectors and the checker are released (allocated
   memory printed before and after): black-forest-labs/FLUX.1-dev's full
   bundle (transformer, T5-XXL, CLIP-L, 16-channel VAE; 33.7 GB in bf16,
   seeded random weights drawn on the card), two 1024^2 28-step jobs
   through the worker, one at a time (the worker's first poll must
   advertise `flux_runnable` 1 and not name flux among
   `unconverted_families`), then four jobs with explicit steps
   and guidance as one coalesced pass, and its first job alone; every
   envelope checked as the SD path's, launches held to 57 attention
   launches a transformer call plus one decode an image (1 attention, 30
   GroupNorm); one full-width transformer call in bf16 through the
   kernels held to f32 on the plain path, block by block, within
   E2E_RATIO x the plain bf16 path's error, and profiled; then dev
   released and black-forest-labs/FLUX.1-schnell built for one 4-step job
   at 256 T5 tokens. Resident and peak bytes are printed.
   The Kandinsky 3 path (`serve_kandinsky3_path`) and the Stable Cascade
   path (`serve_cascade_path`) follow, each in a registry of its own: the
   published bundles (FLAN-UL2's T5 encoder, the UNet and MoVQ; stage C
   with CLIP-bigG; stage B with CLIP-bigG and the Paella VQ) on seeded
   weights written as bf16 diffusers safetensors; the setup CLI (`python3
   -m chiaswarm_tpu_torch.initialize --silent --check --models ...`) over
   every tree written, each "ok" with the served modules' parameter
   counts, and over a copy of the K3 tree with one MoVQ tensor removed
   (FAILED naming it, exit 1); the bundles built from the files and their
   folders removed; K3 txt2img and img2img (strength 0.75) at 1024^2, 25
   DDPM steps at guidance 3.0, a Cascade prior-as-main job with a
   `decoder` dict and a StableCascadeCombinedPipeline job at 1024^2 (20
   guided prior steps, 10 unguided decoder steps) through the worker,
   launches held to the configs' arithmetic (`k3_calls`,
   `cascade_calls`) in total and shape by shape; the bf16 parameter
   bytes, job, stage and step times printed; a K3 UNet call, a stage C
   call and a stage B call in bf16 through the kernels held to f32 on the
   plain path within E2E_RATIO, and profiled with a MoVQ and a Paella
   decode.
6. After the Kandinsky 3 and Stable Cascade paths: each kernel at every shape any path launched it with: again held
   against its plain version, and timed (CUDA events) beside its plain
   version and one PyTorch library call computing the same function, each
   also replayed from a CUDA graph (the device's own time, without the
   host's launch cost), the wrapper's host time per call (launched back
   to back, unsynchronised; both with fewer launches where one call is
   long, to spend about 100 ms of device time each), and its bound on the H100 (bytes over
   3.35 TB/s or operations over the peak of their type, whichever is
   larger), with the achieved TFLOP/s and the share of the bound reached.
   A kernel's bound per job is the sum over its shapes of each shape's
   bound times its launches per job, for each kind of job.
7. The UNet (one call), the VAE decode and the VAE encode at the main
   path's shapes in bf16 through the kernels, against the same weights in
   f32 on the plain path: the relative RMS error may be at most 1.25x
   that of the plain path in bf16. The same for one SD 1.5 UNet call at
   512^2, one SD 2.1 UNet call at 768^2, one SDXL refiner UNet call at
   1024^2 and one SD 1.5 pix2pix UNet call (3 CFG rows, 8 input channels)
   at 512^2.
8. A few UNet calls, one VAE decode and one VAE encode at the main path's
   shapes, and a few SD 1.5, SD 2.1, refiner and SD 1.5 pix2pix UNet calls
   at theirs, timed by the host's clock and then under torch.profiler: device time and launches
   by kernel category (attention's share of the device time), the
   GroupNorm kernels one by one, and the device's busy share. Each
   GroupNorm call must be exactly one kernel launch.

The second-to-last lines are the `kernels` JSON object (per txt2img job,
as before; `launches` over every served job; `by_job` per job of each
kind; attention's `routes`, the launches of each route over every served
job) and the card's name and power limit; the last line is the
`{"ok": true, ...}` object. Each phase's wall time is logged as it
ends (`[time]` lines).
`--detail PATH` also writes every measurement (per shape, per job, the
profile) to PATH as JSON. `--group-norm-only` runs phases 1 and 2, then
GroupNorm alone at the shapes of one UNet call and one VAE decode (its
launches per job counted from those calls: STEPS UNet calls and one
decode), and phase 8 without its one-launch check; it compares one tree's
GroupNorm kernel with another's in one call, and prints no result line.
`--attention-only` is its counterpart for attention: phases 1 and 2 (the
attention library alone), phase 3's attention checks, then phase 6 at
the shapes of one UNet call and one VAE decode of SDXL, SD 1.5 and SD
2.1 (per job: STEPS UNet calls and one decode); it runs on trees whose
wrapper reports no routes too.
"""

from __future__ import annotations

import argparse
import asyncio
import base64
import hashlib
import io
import json
import subprocess
import sys
import time
from collections import Counter
from contextlib import contextmanager, nullcontext
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
SDXL = "stabilityai/stable-diffusion-xl-base-1.0"
SDXL_INPAINT = "diffusers/stable-diffusion-xl-1.0-inpainting-0.1"
SD15 = "runwayml/stable-diffusion-v1-5"
SD15_INPAINT = "runwayml/stable-diffusion-inpainting"
SD21 = "stabilityai/stable-diffusion-2-1"
REFINER = "stabilityai/stable-diffusion-xl-refiner-1.0"
SD15_P2P = "timbrooks/instruct-pix2pix"
SDXL_P2P = "diffusers/sdxl-instructpix2pix-768"
# a tiny SD model whose scheduler config (written by phase 4) says v_prediction
TINY_V = "test/tiny-sd-v"
# SD 1.x and SD 2.x at their canvases (phases 7 and 8)
SD_CANVASES = ((SD15, 512), (SD21, 768))
N_JOBS = 3
STEPS = 30
# the batched path's depth: each group is served twice (coalesced, then
# job by job), so it runs at half the steps to keep the whole smoke near
# its time budget; launches and rates are per job at this depth
BATCHED_STEPS = 15
SIZE = 1024
# the smoke's workers poll the fake hive every 0.05 s while idle; while a
# pass runs, their cancel-only heartbeat polls every HEARTBEAT_SECONDS
HEARTBEAT_SECONDS = 0.5
FLUX_DEV = "black-forest-labs/FLUX.1-dev"
FLUX_SCHNELL = "black-forest-labs/FLUX.1-schnell"
# FLUX.1-dev's and FLUX.1-schnell's published step counts
FLUX_DEV_STEPS = 28
FLUX_SCHNELL_STEPS = 4

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s and flop/s by type
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

# Tolerances. Every kernel output is compared with the plain version run
# in f32 on the same inputs (for bf16, the bf16 values cast up).
# - f32: 2e-5, the bound of the JAX package's kernel tests
#   (tests/test_flash_attention.py, tests/test_group_norm.py).
# - bf16 attention, elementwise: the f32 bound plus bf16 roundings of
#   unit roundoff u = 2^-8: P rounded before P.V (at most u * P|v|, with
#   P the softmax weights), the row sum if it adds the rounded terms
#   (u * |o|) and the output's own rounding (u * |o|). On top of that the
#   RMS error must not exceed that of the plain version run in bf16, which
#   rounds at the same places and also rounds its logits: the kernel keeps
#   scores in f32, so it is at least as accurate. A lost or mis-masked KV
#   tile moves outputs by whole softmax terms, far past either line.
# - bf16 GroupNorm: the f32 bound plus one rounding of the output
#   (u * |y|); statistics and affine are f32 in the kernel.
U_BF16 = 2.0 ** -8
F32_TOL = 2e-5
GN_TOL = {torch.float32: (F32_TOL, F32_TOL), torch.bfloat16: (F32_TOL, F32_TOL + U_BF16)}
# the whole UNet / VAE decode in bf16 through the kernels, against the
# same modules in f32 on the plain path: relative RMS error at most this
# many times that of the plain path in bf16 (both round every matmul and
# conv to bf16 alike; the kernels only remove roundings)
E2E_RATIO = 1.25

KERNELS = {
    "flash_attention": {
        "source": "chiaswarm_tpu_torch/csrc/flash_attention.cu",
        "replaces": "chiaswarm_tpu/ops/flash_attention.py:142",
    },
    "group_norm": {
        "source": "chiaswarm_tpu_torch/csrc/group_norm.cu",
        "replaces": "chiaswarm_tpu/ops/group_norm.py:97",
    },
}


def log(*args) -> None:
    print(*args, flush=True)


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


# --- phase 1 ---

def device_probe() -> str:
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    cap = torch.cuda.get_device_capability(0)
    check(cap == (9, 0), f"compute capability {cap}, the kernels need 9.0 (sm_90a)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"[probe] {torch.cuda.get_device_name(0)} capability {cap}; torch "
        f"{torch.__version__} cuda {torch.version.cuda}; nvidia-smi: {smi}")
    return smi


# --- timing and bounds ---

# the device time that graph_ms and host_ms spend on one shape at most,
# launches allowing: phase 6 times about 300 shapes, some of them calls of
# tens of ms
TIMING_BUDGET_MS = 100.0


def _once_ms(fn) -> float:
    """One call of fn() timed by CUDA events, after the caller's warm-up."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return max(start.elapsed_time(end), 1e-3)


def time_ms(fn, min_total_ms: float = 30.0, max_iters: int = 50) -> float:
    """Mean device time of fn() over repeated launches (CUDA events),
    after one warm-up call."""
    fn()
    iters = int(min(max_iters, max(3, min_total_ms / _once_ms(fn))))
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, launches: int = 20, replays: int = 5) -> float:
    """Mean device time of fn() captured up to `launches` times in a CUDA
    graph and replayed up to `replays` times: the kernel's own time,
    without the host's cost of launching it (which time_ms includes when a
    launch is shorter than the host's work per call). A call that takes
    longer than TIMING_BUDGET_MS / (launches * replays) is captured and
    replayed fewer times, at least once: its launch cost is lost in its
    length."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    once = _once_ms(fn)
    launches = max(1, min(launches, int(TIMING_BUDGET_MS / replays / once)))
    replays = max(1, min(replays, int(TIMING_BUDGET_MS / launches / once)))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (launches * replays)


def host_ms(fn, calls: int = 200) -> float:
    """Mean host time of one call of fn, launched back to back with no
    synchronisation (fewer calls than the launch queue holds, so the host
    never waits for the card): the wrapper's own cost per call. A call
    that keeps the card busy longer than TIMING_BUDGET_MS / calls is
    launched fewer times, at least 10."""
    fn()
    calls = max(10, min(calls, int(TIMING_BUDGET_MS / _once_ms(fn))))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e3 * elapsed / calls


def attention_work(q_shape, k_shape, dtype) -> tuple[float, float]:
    """(flops, bytes): q, k, v read once, the output written once."""
    b, sq, h, d = q_shape
    skv = k_shape[1]
    size = torch.tensor([], dtype=dtype).element_size()
    return 4.0 * b * h * sq * skv * d, size * (2 * b * sq * h * d + 2 * b * skv * h * d)


def gn_work(x_shape, dtype) -> tuple[float, float]:
    """(flops, bytes): about 10 f32 operations an element (statistics,
    normalisation, affine, SiLU); x and y once each, scale and bias."""
    numel = 1
    for s in x_shape:
        numel *= s
    size = torch.tensor([], dtype=dtype).element_size()
    return 10.0 * numel, 2 * numel * size + 2 * x_shape[-1] * size


def bound_fields(flops: float, nbytes: float, peak: float) -> dict:
    """ms for the operations at their type's peak and for the bytes at the
    memory rate; the shape's bound is the larger."""
    ops_ms, bytes_ms = 1e3 * flops / peak, 1e3 * nbytes / HBM_BYTES_S
    return {"flops": flops, "ops_ms": ops_ms, "bytes_ms": bytes_ms,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


# --- the kernels against their plain versions ---

def rand(shape, dtype, gen, scale=1.0, shift=0.0):
    return (torch.randn(shape, device="cuda", generator=gen) * scale + shift).to(dtype)


def rms(t) -> float:
    return t.float().square().mean().sqrt().item()


def plain_attention(q, k, v):
    """The plain version over chunks whose f32 logits stay under 2 GiB: of
    the batch (a coalesced pass's batch would need tens of GiB at once)
    and, where one batch row is past that (the 2048^2 decode's 65536
    tokens: 16 GiB), of its queries, each chunk against all keys;
    attention is independent per batch row and per query, so the result
    is the same."""
    from chiaswarm_tpu_torch.ops.flash_attention import reference_attention

    limit = 1 << 31
    per_query = 4 * q.shape[2] * k.shape[1]
    if per_query * q.shape[1] > limit:
        step = max(1, limit // per_query)
        return torch.cat([plain_attention(q[:, i:i + step], k, v)
                          for i in range(0, q.shape[1], step)], dim=1)
    rows = max(1, limit // (per_query * q.shape[1]))
    if rows >= q.shape[0]:
        return reference_attention(q, k, v)
    return torch.cat([reference_attention(q[i:i + rows], k[i:i + rows], v[i:i + rows])
                      for i in range(0, q.shape[0], rows)])


def attention_case(q_shape, k_shape, dtype, gen, timed: bool) -> dict:
    import torch.nn.functional as F

    from chiaswarm_tpu_torch.ops.flash_attention import flash_attention

    reference_attention = plain_attention

    q, k, v = rand(q_shape, dtype, gen), rand(k_shape, dtype, gen), rand(k_shape, dtype, gen)
    out, route = with_route(lambda: flash_attention(q, k, v))
    out = out.float()
    torch.cuda.synchronize()
    qf, kf, vf = q.float(), k.float(), v.float()
    ref = reference_attention(qf, kf, vf)
    diff = (out - ref).abs()
    err = diff.max().item()
    row = {"q": list(q_shape), "kv": list(k_shape), "dtype": str(dtype)[6:],
           "max_abs_err": err, "route": route}
    what = f"flash_attention {q_shape}x{k_shape} {dtype}"
    check_tensor_core_route(route, dtype, q_shape[-1], what)
    if dtype == torch.float32:
        row["bound"] = f"{F32_TOL:g}"
        check(err <= F32_TOL, f"{what}: err {err} > {F32_TOL}")
    else:
        bound = F32_TOL + U_BF16 * (2 * ref.abs() + reference_attention(qf, kf, vf.abs()))
        excess = (diff - bound).max().item()
        row["rms_err"], row["plain_rms_err"] = rms(diff), rms(reference_attention(q, k, v) - ref)
        row["bound"] = (f"2e-5 + 2^-8 (2|o| + P|v|), RMS <= plain bf16's "
                        f"{row['plain_rms_err']:.3g}")
        check(excess <= 0, f"{what}: err {err} beyond 2e-5 + 2^-8 (2|o| + P|v|) by {excess}")
        check(row["rms_err"] <= row["plain_rms_err"],
              f"{what}: RMS err {row['rms_err']} > plain bf16's {row['plain_rms_err']}")
    del diff, ref
    if timed:
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        row.update(
            ms=time_ms(lambda: flash_attention(q, k, v)),
            device_ms=graph_ms(lambda: flash_attention(q, k, v)),
            host_ms=host_ms(lambda: flash_attention(q, k, v)),
            plain_ms=time_ms(lambda: reference_attention(q, k, v)),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt)),
            library_device_ms=graph_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt)),
            **bound_fields(*attention_work(q_shape, k_shape, dtype), PEAK_FLOPS[dtype]))
    return row


def with_route(call) -> tuple:
    """(call(), the route that the kernel reported for that one launch),
    the route None for a tree whose wrapper does not report routes
    (`--attention-only` also measures such a tree, for comparison)."""
    from chiaswarm_tpu_torch.ops.flash_attention import COUNTER

    routes = getattr(COUNTER, "routes", None)
    if routes is None:
        return call(), None
    before = Counter(routes)
    out = call()
    new = Counter(routes) - before
    check(sum(new.values()) == 1, f"one call reported routes {dict(new)}")
    return out, next(iter(new))[0]


def check_tensor_core_route(route: str | None, dtype, d: int, what: str) -> None:
    """bf16 at a tensor-core head width must not take the FMA kernel."""
    from chiaswarm_tpu_torch.ops import flash_attention as fa

    if route is None:
        return
    if dtype == torch.bfloat16 and d in fa.TENSOR_CORE_WIDTHS:
        check(route == f"wgmma-d{d}", f"{what}: route {route}, not the tensor-core kernel")


def gn_plan_fields(x, silu: bool) -> dict:
    """The launch plan the wrapper takes for x: whether the call stays on
    chip (x read once) or reads part of x again. Empty for a tree whose
    wrapper has no plan (`--group-norm-only` also measures such a tree, the
    three-launch kernel, for comparison)."""
    import importlib

    # (the package's `group_norm` attribute is the function, not the module)
    gn = importlib.import_module("chiaswarm_tpu_torch.ops.group_norm")
    plan_of = getattr(gn, "launch_plan", None)
    if plan_of is None:
        return {}
    plan = plan_of(x, 32, silu)
    return {"on_chip": plan.on_chip, "grid": plan.grid, "rows_per_cta": plan.rows_per_cta,
            "keep_rows": plan.keep_rows, "smem_bytes": plan.smem_bytes}


def gn_case(x_shape, dtype, silu: bool, gen, timed: bool, eps: float = 1e-5,
            shift: float = 0.3, spread: float = 2.0, exact: bool = False) -> dict:
    """The kernel on x = shift + spread * randn against the plain version,
    which runs in f32 on the same inputs as in the JAX test (in float64
    with `exact`, for inputs whose f32 statistics the plain version itself
    loses to cancellation)."""
    import torch.nn.functional as F

    from chiaswarm_tpu_torch.ops.group_norm import fused_group_norm, reference_group_norm

    x = rand(x_shape, dtype, gen, spread, shift)
    scale, bias = rand(x_shape[-1:], dtype, gen), rand(x_shape[-1:], dtype, gen)
    out = fused_group_norm(x, scale, bias, 32, eps, silu)
    torch.cuda.synchronize()
    wide = torch.float64 if exact else torch.float32
    atol, rtol = GN_TOL[dtype]
    err = excess = -float("inf")
    # by chunks of the batch of at most 1 GiB in float64 (GroupNorm is per
    # batch row, so the plain version is the same on a chunk)
    rows = max(1, (1 << 30) // (8 * x[0].numel()))
    for i in range(0, x_shape[0], rows):
        ref = reference_group_norm(x[i:i + rows].to(wide), scale.to(wide), bias.to(wide), 32,
                                   eps, silu)
        # in place: a 2048^2 VAE row is 4 GiB in f32 for each temporary
        diff = out[i:i + rows].to(wide).sub_(ref).abs_()
        err = max(err, diff.max().item())
        excess = max(excess, diff.sub_(ref.abs_().mul_(rtol).add_(atol)).max().item())
        del diff, ref
    row = {"x": list(x_shape), "dtype": str(dtype)[6:], "silu": silu, "eps": eps,
           "max_abs_err": err, "bound": f"{atol:g} + {rtol:.4g} |y|",
           **gn_plan_fields(x, silu)}
    check(excess <= 0, f"group_norm {x_shape} {dtype} eps {eps}: err {err} beyond "
                       f"{row['bound']} by {excess}")
    if timed:
        xc = x.movedim(-1, 1)  # NC... view of the channel-last rows (3-D tokens too)

        def kernel():
            return fused_group_norm(x, scale, bias, 32, eps, silu)

        def library():
            y = F.group_norm(xc, 32, scale, bias, eps)
            return F.silu(y) if silu else y

        row.update(
            ms=time_ms(kernel), device_ms=graph_ms(kernel), host_ms=host_ms(kernel),
            plain_ms=time_ms(lambda: [reference_group_norm(x[i:i + rows], scale, bias, 32,
                                                           eps, silu)
                                      for i in range(0, x_shape[0], rows)]),
            library_ms=time_ms(library), library_device_ms=graph_ms(library),
            **bound_fields(*gn_work(x_shape, dtype), PEAK_FLOPS[torch.float32]))
    return row


def gn_repeat_check(x_shape, dtype, gen, runs: int = 20) -> None:
    """One input through the kernel `runs` times: the outputs must be equal
    bit for bit (a racy grid barrier, or a reduction whose order moves from
    call to call, shows here)."""
    from chiaswarm_tpu_torch.ops.group_norm import fused_group_norm

    x = rand(x_shape, dtype, gen, 2.0, 0.3)
    scale, bias = rand(x_shape[-1:], dtype, gen), rand(x_shape[-1:], dtype, gen)
    first = fused_group_norm(x, scale, bias, 32, 1e-5, True)
    differ = sum(not torch.equal(fused_group_norm(x, scale, bias, 32, 1e-5, True), first)
                 for _ in range(runs - 1))
    log(f"[check] group_norm x{x_shape} {str(dtype)[6:]}: {runs} runs of one input, "
        f"{differ} differ from the first bit for bit {gn_plan_fields(x, True)}")
    check(differ == 0, f"group_norm {x_shape} {dtype}: {differ} of {runs} runs differ")


# The attention of each served model's UNet, by level: (channels,
# transformer layers, heads) per level, the mid block's layers, and the
# canvas. Plain numbers, not the package's configs, so that
# `--attention-only` runs on trees that lack a model.
UNET_ATTENTION = {
    "sdxl": ((320, 640, 1280), (0, 2, 10), (5, 10, 20), 10, 1024),
    "sd15": ((320, 640, 1280, 1280), (1, 1, 1, 0), (8, 8, 8, 8), 1, 512),
    "sd21": ((320, 640, 1280, 1280), (1, 1, 1, 0), (5, 10, 20, 20), 1, 768),
    "refiner": ((384, 768, 1536, 1536), (0, 4, 4, 0), (6, 12, 24, 24), 4, 1024),
}


def attention_shapes(model: str, rows: int = 2, size: int | None = None) -> Counter:
    """{(q shape, kv shape, dtype): launches} of one bf16 UNet call of
    `model` at `size` (its canvas unless given) with `rows` CFG rows (2;
    pix2pix 3), 77 context tokens, two resnets a down block and three an
    up block, each with its transformer, every transformer layer one self-
    and one cross-attention."""
    channels, layers, heads, mid, canvas = UNET_ATTENTION[model]
    shapes = Counter()
    side = (size or canvas) // 8
    for level, (ch, n, h) in enumerate(zip(channels, layers, heads)):
        q = (rows, (side >> level) ** 2, h, ch // h)
        calls = n * 5 + (mid if level == len(channels) - 1 else 0)
        if calls:
            shapes[(q, q, torch.bfloat16)] += calls
            shapes[(q, (rows, 77, h, ch // h), torch.bfloat16)] += calls
    return shapes


def unet_norms(model: str, rows: int = 2, size: int | None = None) -> list:
    """Every distinct GroupNorm call (x, silu, eps) of one UNet call of
    `model` (UNET_ATTENTION's structure) at `size` with `rows` CFG rows:
    each resnet's two norms (its input's channels, then its output's; an
    up block's resnets take the skip concatenated), each transformer's
    input norm (eps 1e-6, no SiLU) and the output norm."""
    channels, layers, _, _, canvas = UNET_ATTENTION[model]
    side = (size or canvas) // 8
    calls = {}

    def norm(c, s, silu=True):
        key = ((rows, s, s, c), silu, 1e-5 if silu else 1e-6)
        calls[key] = None

    ch, skips = channels[0], [channels[0]]
    for level, (out, n) in enumerate(zip(channels, layers)):
        for _ in range(2):
            norm(ch, side >> level)
            norm(out, side >> level)
            if n:
                norm(out, side >> level, silu=False)
            ch = out
            skips.append(out)
        if level < len(channels) - 1:
            skips.append(out)
    norm(ch, side >> (len(channels) - 1))
    norm(ch, side >> (len(channels) - 1), silu=False)
    for level in reversed(range(len(channels))):
        out = channels[level]
        for _ in range(3):
            norm(ch + skips.pop(), side >> level)
            norm(out, side >> level)
            if layers[level]:
                norm(out, side >> level, silu=False)
            ch = out
    norm(channels[0], side)
    return list(calls)


# the pix2pix jobs' UNet calls (3 CFG rows) and the refiner's: (model key,
# rows, canvas)
EDIT_CALLS = (("sd15", 3, 512), ("sdxl", 3, 768), ("refiner", 2, 1024))


def vae_attention_shape(model: str) -> tuple:
    """The VAE mid block's single 512-wide head at `model`'s canvas."""
    q = (1, (UNET_ATTENTION[model][-1] // 8) ** 2, 1, 512)
    return q, q, torch.bfloat16


# every GroupNorm call of the SD 1.x 512^2 UNet, the SD 2.x 768^2 UNet and
# their VAE's decoder and encoder at 512^2 and 768^2: (x, silu, eps)
SD_NORMS = [
    ((2, s, s, c), True, 1e-5) for s, c in (
        (64, 320), (32, 320), (32, 640), (16, 640), (16, 1280), (8, 1280), (8, 2560),
        (16, 2560), (16, 1920), (32, 1920), (32, 1280), (32, 960), (64, 960), (64, 640),
        (96, 320), (48, 320), (48, 640), (24, 640), (24, 1280), (12, 1280), (12, 2560),
        (24, 2560), (24, 1920), (48, 1920), (48, 1280), (48, 960), (96, 960), (96, 640))
] + [
    ((2, s, s, c), False, 1e-6) for s, c in (
        (64, 320), (32, 640), (16, 1280), (8, 1280), (96, 320), (48, 640), (24, 1280),
        (12, 1280))
] + [
    ((1, s, s, c), True, 1e-6) for s, c in (
        (64, 512), (128, 512), (256, 512), (256, 256), (512, 256), (512, 128), (256, 128),
        (128, 256), (96, 512), (192, 512), (384, 512), (384, 256), (768, 256), (768, 128),
        (384, 128), (192, 256))
] + [((1, 64, 64, 512), False, 1e-6), ((1, 96, 96, 512), False, 1e-6)]


def attention_checks(gen) -> None:
    """Phase 3 for attention: the shapes of the SDXL 1024^2 path (CFG
    batch 2), bf16, plus the JAX tests' f32 shapes and full-size f32 rows;
    every shape of the SD 1.x 512^2 and SD 2.x 768^2 UNet calls and VAE
    decodes in bf16 and f32; and the edges of the tiles at every
    tensor-core head width. Each bf16 call at such a width must report the
    tensor-core route."""
    bf, f32 = torch.bfloat16, torch.float32
    attention = [
        ((2, 4096, 10, 64), (2, 4096, 10, 64), bf), ((2, 4096, 10, 64), (2, 77, 10, 64), bf),
        ((2, 1024, 20, 64), (2, 1024, 20, 64), bf), ((2, 1024, 20, 64), (2, 77, 20, 64), bf),
        ((1, 16384, 1, 512), (1, 16384, 1, 512), bf),
        # edges of the tiles (192 query rows and 128 KV rows at D = 64, 64
        # and 64 at D = 512): ragged lengths, a query shorter than a tile,
        # and more than one (batch, head) at D = 512
        ((2, 1000, 10, 64), (2, 77, 10, 64), bf), ((2, 1000, 10, 64), (2, 1000, 10, 64), bf),
        ((2, 1000, 10, 64), (2, 4095, 10, 64), bf), ((2, 40, 10, 64), (2, 77, 10, 64), bf),
        ((2, 40, 10, 64), (2, 4096, 10, 64), bf), ((2, 4096, 1, 512), (2, 4096, 1, 512), bf),
        ((1, 40, 1, 512), (1, 1000, 1, 512), bf),
        # the VAE encoder's mid-block attention (the decoder's shape) in f32
        ((1, 16384, 1, 512), (1, 16384, 1, 512), f32),
        ((2, 256, 3, 32), (2, 256, 3, 32), f32), ((2, 256, 3, 32), (2, 77, 3, 32), f32),
        ((2, 130, 3, 32), (2, 256, 3, 32), f32), ((2, 64, 3, 32), (2, 64, 3, 32), f32),
        ((2, 1024, 10, 64), (2, 77, 10, 64), f32), ((1, 1024, 1, 512), (1, 1024, 1, 512), f32),
    ]
    for model in ("sd15", "sd21"):
        for q_shape, k_shape, _ in (*attention_shapes(model), vae_attention_shape(model)):
            attention += [(q_shape, k_shape, bf), (q_shape, k_shape, f32)]
    # edges at D = 40, 80 and 160 (192 query rows and 128 KV rows at 40, 128
    # and 128 at 80, 128 and 64 at 160): query and KV lengths that are not
    # multiples of a tile, 77 KV rows, a query shorter than 64 rows, and
    # B*H of 1
    for d in (40, 80, 160):
        attention += [((2, 1000, 8, d), (2, 77, 8, d), bf), ((2, 1000, 8, d), (2, 1000, 8, d), bf),
                      ((2, 1000, 8, d), (2, 4095, 8, d), bf), ((2, 40, 8, d), (2, 77, 8, d), bf),
                      ((2, 40, 8, d), (2, 4096, 8, d), bf), ((1, 40, 1, d), (1, 1000, 1, d), bf),
                      ((1, 200, 1, d), (1, 77, 1, d), f32)]
    for q_shape, k_shape, dtype in attention:
        row = attention_case(q_shape, k_shape, dtype, gen, timed=False)
        log(f"[check] flash_attention q{q_shape} kv{k_shape} {row['dtype']} route {row['route']}: "
            f"max_abs_err {row['max_abs_err']:.3g}"
            + (f", RMS err {row['rms_err']:.3g}" if "rms_err" in row else "")
            + f" (bound {row['bound']})")


# Flux's joint attention: 24 heads of 128 over the T5 tokens and the 2x2
# patches of the 16-channel latents, one call in each of the 19 double and
# 38 single blocks of a transformer call. Plain numbers, as UNET_ATTENTION
# (`--attention-only` runs on trees without the Flux modules).
FLUX_HEADS, FLUX_HEAD_DIM, FLUX_BLOCKS = 24, 128, 19 + 38


def flux_tokens(size: int = SIZE, txt: int = 512) -> int:
    """Joint-attention tokens of a Flux call at size^2: the T5 tokens, then
    one per 2x2 patch of the size/8 latents."""
    return txt + (size // 16) ** 2


def flux_attention_shape(rows: int = 1, size: int = SIZE, txt: int = 512) -> tuple:
    q = (rows, flux_tokens(size, txt), FLUX_HEADS, FLUX_HEAD_DIM)
    return q, q, torch.bfloat16


def flux_checks(gen) -> None:
    """Phase 3 for Flux: its joint attention at D = 128, in bf16 and f32,
    at 1024^2 with 512 T5 tokens (4608 rows), with 256 (4352, schnell's
    shorter context), two images at 768^2 (2816) and a coalesced pass of
    four at 1024^2; and the edges of the D = 128 tiles (128 query rows
    and 128 KV rows): lengths that are not multiples of a tile, 77 KV rows,
    a query shorter than 64 rows, B*H of 1. Each bf16 call must report the
    tensor-core route, `wgmma-d128`."""
    bf, f32 = torch.bfloat16, torch.float32
    d = FLUX_HEAD_DIM
    shapes = [flux_attention_shape(1), flux_attention_shape(1, txt=256),
              flux_attention_shape(2, 768), flux_attention_shape(4)]
    attention = [(q, k, dtype) for q, k, _ in shapes for dtype in (bf, f32)]
    attention += [((2, 1000, 8, d), (2, 77, 8, d), bf), ((2, 1000, 8, d), (2, 1000, 8, d), bf),
                  ((2, 1000, 8, d), (2, 4095, 8, d), bf), ((2, 40, 8, d), (2, 77, 8, d), bf),
                  ((2, 40, 8, d), (2, 4096, 8, d), bf), ((1, 40, 1, d), (1, 1000, 1, d), bf),
                  ((1, 200, 1, d), (1, 77, 1, d), f32), ((1, 1000, 1, d), (1, 4095, 1, d), f32)]
    for q_shape, k_shape, dtype in attention:
        row = attention_case(q_shape, k_shape, dtype, gen, timed=False)
        if dtype == bf:
            check(row["route"] in (None, "wgmma-d128"),
                  f"flash_attention {q_shape} bf16: route {row['route']}, not wgmma-d128")
        log(f"[check] flash_attention q{q_shape} kv{k_shape} {row['dtype']} route {row['route']} "
            f"(flux): max_abs_err {row['max_abs_err']:.3g}"
            + (f", RMS err {row['rms_err']:.3g}" if "rms_err" in row else "")
            + f" (bound {row['bound']})")


def edit_checks(gen) -> None:
    """Phase 3 for the pix2pix and refiner calls: every attention and
    GroupNorm shape of an SD 1.5 pix2pix UNet call at 512^2 and an SDXL one
    at 768^2 (3 CFG rows), and of an SDXL refiner UNet call at 1024^2
    (C = 384 to 3072, its skip concatenations at 128^2 and 64^2), each in
    bf16 and f32. Each bf16 attention call must report the tensor-core
    route."""
    for model, rows, size in EDIT_CALLS:
        for q_shape, k_shape, _ in attention_shapes(model, rows, size):
            for dtype in (torch.bfloat16, torch.float32):
                row = attention_case(q_shape, k_shape, dtype, gen, timed=False)
                log(f"[check] flash_attention q{q_shape} kv{k_shape} {row['dtype']} route "
                    f"{row['route']} ({model}, {rows} rows, {size}^2): max_abs_err "
                    f"{row['max_abs_err']:.3g}"
                    + (f", RMS err {row['rms_err']:.3g}" if "rms_err" in row else "")
                    + f" (bound {row['bound']})")
        for x_shape, silu, eps in unet_norms(model, rows, size):
            for dtype in (torch.bfloat16, torch.float32):
                row = gn_case(x_shape, dtype, silu, gen, timed=False, eps=eps)
                log(f"[check] group_norm x{x_shape} {row['dtype']} silu={silu} eps {eps:g} "
                    f"({model}, {rows} rows, {size}^2): max_abs_err {row['max_abs_err']:.3g} "
                    f"(bound {row['bound']})"
                    + (f", on chip: {row['on_chip']}" if "on_chip" in row else ""))


def kernel_checks() -> None:
    """Phase 3: attention (attention_checks), GroupNorm at the shapes of the
    served paths and the edges of its launch plan, and both at the pix2pix
    and refiner calls (edit_checks)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf, f32 = torch.bfloat16, torch.float32
    attention_checks(gen)
    edit_checks(gen)
    norms = [((2, 128, 128, c), bf, True) for c in (320, 640)]
    norms += [((2, 64, 64, c), bf, True) for c in (640, 960, 1280, 1920)]
    norms += [((2, 32, 32, c), bf, True) for c in (1280, 1920, 2560)]
    norms += [((1, 1024, 1024, 128), bf, True), ((1, 128, 128, 512), bf, False),
              ((2, 8, 8, 64), f32, True), ((1, 16, 16, 96), f32, False),
              ((2, 64, 64, 640), f32, True), ((1, 1024, 1024, 128), f32, True)]
    norms = [(*n, 1e-5) for n in norms]
    # edges of the launch plan: rows that do not divide among the CTAs; B = 1
    # against B = 2 at the same N*C (a CTA's rows straddle two batch rows
    # only in the second); groups straddling an 8-channel vector in f32;
    # the main-path calls too large to stay on chip, in bf16 and f32; eps 1e-6
    norms += [((2, 33, 31, 640), bf, True, 1e-5), ((2, 33, 31, 640), f32, False, 1e-5),
              ((1, 64, 128, 640), bf, True, 1e-5), ((2, 64, 64, 640), bf, True, 1e-5),
              ((2, 40, 40, 320), f32, True, 1e-5), ((2, 32, 32, 2560), f32, True, 1e-5),
              ((2, 64, 64, 1920), f32, True, 1e-5), ((2, 128, 128, 960), bf, True, 1e-5),
              ((2, 128, 128, 960), f32, True, 1e-5), ((2, 128, 128, 320), f32, True, 1e-5),
              ((2, 64, 64, 640), bf, False, 1e-6), ((1, 256, 256, 512), bf, True, 1e-6)]
    # the VAE encoder's calls that the decoder never makes (both too large
    # to stay on chip)
    norms += [(shape, dtype, True, 1e-6) for shape in ((1, 512, 512, 128), (1, 256, 256, 256))
              for dtype in (bf, f32)]
    # every call of the SD 1.x 512^2 and SD 2.x 768^2 UNets (CFG batch 2) and
    # of their VAE's decoder and encoder at those canvases, in bf16; in f32
    # the one UNet call too large to stay on chip and two VAE calls
    norms += [(shape, bf, silu, eps) for shape, silu, eps in SD_NORMS]
    norms += [((2, 96, 96, 960), f32, True, 1e-5), ((1, 768, 768, 128), f32, True, 1e-6),
              ((1, 96, 96, 512), f32, False, 1e-6)]
    for x_shape, dtype, silu, eps in norms:
        row = gn_case(x_shape, dtype, silu, gen, timed=False, eps=eps)
        log(f"[check] group_norm x{x_shape} {row['dtype']} silu={silu} eps {eps:g}: max_abs_err "
            f"{row['max_abs_err']:.3g} (bound {row['bound']})"
            + (f", on chip: {row['on_chip']}" if "on_chip" in row else ""))
    # a mean ten times the spread: E[x^2] - mean^2 cancels two digits, and an
    # f32 sum of the CTAs' partials would leave the bound; the kernel's
    # double finalize holds it. (At 500 times, as x = 50 + 0.1 randn, the
    # f32 statistics that the function keeps lose the variance in any
    # order of summation, so no f32 version, the plain one included, can
    # be held to the bound there.)
    row = gn_case((1, 512, 512, 256), f32, True, gen, timed=False, shift=10.0, spread=1.0,
                  exact=True)
    log(f"[check] group_norm x(1, 512, 512, 256) f32 = 10 + randn against the plain version "
        f"in float64: max_abs_err {row['max_abs_err']:.3g} (bound {row['bound']})")
    gn_repeat_check((2, 64, 64, 640), bf, gen)
    gn_repeat_check((2, 128, 128, 640), bf, gen)


# the coalesced UNet calls of the batched path: (model key, CFG rows,
# canvas); SD 1.5 at the largest pass the capacity admits (64 images)
BATCHED_CALLS = (("sdxl", 8, None), ("sdxl", 16, None), ("sd15", 128, 512))


def batched_checks(gen) -> dict:
    """Phase 3 at the batched path's shapes: every attention and GroupNorm
    call of an SDXL UNet call at 8 and 16 CFG rows and of an SD 1.5 call at
    128 (BATCHED_CALLS), in bf16 and f32. Then the GroupNorm kernel's own
    limit: the most batch rows its plan takes on this card at one CTA per
    SM run, one row more raises ValueError from the wrapper (nothing else),
    and the capacity's pass budget (half the rows, floored to a power of
    two) is what the SD 1.5 512^2 pass is given. -> the limits."""
    from chiaswarm_tpu_torch.capacity import coalesce_rows_limit, kernel_image_limit
    from chiaswarm_tpu_torch.ops.group_norm import fused_group_norm, max_batch_rows

    for model, rows, size in BATCHED_CALLS:
        for q_shape, k_shape, _ in attention_shapes(model, rows, size):
            for dtype in (torch.bfloat16, torch.float32):
                row = attention_case(q_shape, k_shape, dtype, gen, timed=False)
                log(f"[check] flash_attention q{q_shape} kv{k_shape} {row['dtype']} route "
                    f"{row['route']} ({model}, {rows} CFG rows): max_abs_err "
                    f"{row['max_abs_err']:.3g}"
                    + (f", RMS err {row['rms_err']:.3g}" if "rms_err" in row else "")
                    + f" (bound {row['bound']})")
        for x_shape, silu, eps in unet_norms(model, rows, size):
            for dtype in (torch.bfloat16, torch.float32):
                row = gn_case(x_shape, dtype, silu, gen, timed=False, eps=eps)
                log(f"[check] group_norm x{x_shape} {row['dtype']} silu={silu} eps {eps:g} "
                    f"({model}, {rows} CFG rows): max_abs_err {row['max_abs_err']:.3g} (bound "
                    f"{row['bound']})" + (f", on chip: {row['on_chip']}" if "on_chip" in row
                                          else ""))
    props = torch.cuda.get_device_properties(0)
    limit = max_batch_rows(props.multi_processor_count,
                           getattr(props, "shared_memory_per_block_optin", 227 << 10))
    images = kernel_image_limit("cuda")
    check(images == limit // 2, f"pass images {images} from {limit} GroupNorm rows")
    row = gn_case((limit, 8, 8, 320), torch.bfloat16, True, gen, timed=False)
    x = rand((limit + 1, 8, 8, 320), torch.bfloat16, gen)
    scale = bias = rand((320,), torch.bfloat16, gen)
    try:
        fused_group_norm(x, scale, bias, 32, 1e-5, True)
        refused = None
    except Exception as e:  # noqa: BLE001 — what it raises is the check
        refused = e
    check(type(refused) is ValueError,
          f"group_norm at {limit + 1} batch rows: {type(refused).__name__} {refused}, "
          "not ValueError")
    budget = coalesce_rows_limit("cuda", SD15, 512)
    log(f"[check] group_norm takes {limit} batch rows on this card (max_abs_err "
        f"{row['max_abs_err']:.3g} there); {limit + 1} raise ValueError: {refused}; a "
        f"coalesced pass may hold {images} images, {budget} after the power-of-two floor "
        f"(SD 1.5 at 512^2); SDXL at 1024^2: {coalesce_rows_limit('cuda', SDXL, SIZE)}")
    check(budget == 64, f"the SD 1.5 512^2 pass budget is {budget}, not 64")
    return {"group_norm_rows": limit, "pass_images": images, "sd15_budget": budget}


# --- phase 4 ---

def tiny_reference_check(device: str = "cuda", size: int = 128, model: str = "test/tiny-xl",
                         model_root_dir: str | None = None,
                         prediction_type: str = "epsilon") -> int:
    """Phase 4: `model` in f32 on `device` (the kernels on the card)
    against the same weights and latents on the CPU (plain versions),
    both reading the scheduler config under `model_root_dir`; the
    pipelines must denoise with `prediction_type`. -> max pixel diff."""
    import numpy as np

    from chiaswarm_tpu_torch.pipelines.stable_diffusion import SDPipeline

    cpu = SDPipeline(model, device="cpu", model_root_dir=model_root_dir)
    weights = {
        "unet": cpu.unet.state_dict(),
        "text": [e.state_dict() for e in cpu.text_encoders],
        "vae": cpu.vae.state_dict(),
    }
    card = SDPipeline(model, device=device, dtype=torch.float32, weights=weights,
                      model_root_dir=model_root_dir)
    check(cpu.prediction_type == card.prediction_type == prediction_type,
          f"{model}: prediction types {cpu.prediction_type}, {card.prediction_type}, not "
          f"{prediction_type}")
    lat = size // cpu.latent_factor
    latents = torch.randn((1, cpu.latent_channels, lat, lat),
                          generator=torch.Generator().manual_seed(7))
    kw = dict(num_inference_steps=4, height=size, width=size, latents=latents)
    want, _ = cpu.run("a red cube", **kw)
    got, config = card.run("a red cube", **kw)
    diff = int(np.abs(got[0].astype(np.int16) - want[0].astype(np.int16)).max())
    log(f"[tiny] {model} ({prediction_type}) {size}^2 f32, card (kernels) vs CPU (plain): "
        f"max pixel diff {diff}/255 (bound 2/255)")
    check(diff <= 2, f"{model} card vs CPU pixel diff {diff} > 2")
    return diff


def tiny_sd_checks(device: str = "cuda", size: int = 128) -> dict:
    """Phase 4 for SD 1.x / 2.x structure: test/tiny-sd, and a tiny SD model
    whose checkpoint's scheduler config says v_prediction (written to a
    temporary model root), each on `device` against the CPU."""
    import tempfile

    result = {"test/tiny-sd": tiny_reference_check(device, size, "test/tiny-sd")}
    with tempfile.TemporaryDirectory() as root:
        config = Path(root) / TINY_V / "scheduler"
        config.mkdir(parents=True)
        (config / "scheduler_config.json").write_text('{"prediction_type": "v_prediction"}')
        result[TINY_V] = tiny_reference_check(device, size, TINY_V, root, "v_prediction")
    return result


class Resident:
    """A stand-in for the worker's registry over pipelines built by hand."""

    def __init__(self, pipelines: dict):
        self.pipelines = pipelines

    def get_pipeline(self, model_name: str, allow_random_init: bool = False,
                     pipeline_type: str | None = None):
        return self.pipelines[model_name]

    def safety_checker(self):
        from chiaswarm_tpu_torch.pipelines.safety import get_checker

        return get_checker("", None, None)  # none: the envelopes say nsfw_checked false


def write_checkpoint(pipe, model_dir: Path, dtype=None, legacy: bool = False) -> int:
    """`pipe`'s weights as safetensors in a model directory's diffusers
    layout (unet/, vae/, text_encoder[_2]/), cast to `dtype` (the
    pipeline's own unset). Transformer `proj_in` / `proj_out` are written as
    SD 1.x's 1x1 convolutions [C, C, 1, 1]; with `legacy`, also the VAE's
    attention as query/key/value/proj_attn, `position_ids` buffers and one
    text-encoder layer past the config's. -> bytes written."""
    from safetensors.torch import save_file

    parts = {"unet": pipe.unet, "vae": pipe.vae}
    for i, enc in enumerate(pipe.text_encoders):
        parts["text_encoder" + ("_2" if i else "")] = enc
    written = 0
    for folder, module in parts.items():
        state = {}
        for key, value in module.state_dict().items():
            value = value.detach().to("cpu", dtype or value.dtype).contiguous()
            if key.endswith(("proj_in.weight", "proj_out.weight")):
                value = value[:, :, None, None].contiguous()
            if legacy and folder == "vae":
                for new, old in ((".to_q.", ".query."), (".to_k.", ".key."),
                                 (".to_v.", ".value."), (".to_out.0.", ".proj_attn.")):
                    key = key.replace(new, old)
            state[key] = value
        if legacy and folder.startswith("text_encoder"):
            state["text_model.embeddings.position_ids"] = torch.arange(77)[None]
            spare = f"text_model.encoder.layers.{module.config.num_layers}."
            first = "text_model.encoder.layers.0."
            state.update({spare + k[len(first):]: v.clone() for k, v in state.items()
                          if k.startswith(first)})
        (model_dir / folder).mkdir(parents=True, exist_ok=True)
        path = model_dir / folder / "diffusion_pytorch_model.safetensors"
        save_file(state, str(path))
        written += path.stat().st_size
    return written


TINY_EDIT_MODELS = ("test/tiny-pix2pix", "test/tiny-xl-pix2pix", "test/tiny-xl",
                    "test/tiny-xl-refiner", "test/tiny-sd")


def tiny_edit_checks(device: str = "cuda", size: int = 64, steps: int = 4) -> dict:
    """Phase 4 for checkpoints, pix2pix and the refiner: the tiny models'
    seeded weights written as safetensors under a temporary model root
    (test/tiny-sd's in the legacy layout), then loaded from there by
    pipelines in f32 on `device` and served on the CPU by a Registry (five
    models, so it also evicts and rebuilds from the files):
    test/tiny-pix2pix and test/tiny-xl-pix2pix pix2pix jobs, test/tiny-xl
    with test/tiny-xl-refiner chained, and test/tiny-sd txt2img, with the
    same injected noise on both sides; the decoded uint8 images must agree
    within 2/255, and every pipeline must report weights loaded from the
    checkpoint."""
    import shutil
    import tempfile

    import numpy as np

    from chiaswarm_tpu_torch.pipelines.stable_diffusion import SDPipeline
    from chiaswarm_tpu_torch.registry import Registry

    root = Path(tempfile.mkdtemp(prefix="chip-smoke-tiny-"))
    try:
        for model in TINY_EDIT_MODELS:
            write_checkpoint(SDPipeline(model, device="cpu"), root / model,
                             legacy=model == "test/tiny-sd")
        cpu = Registry(torch.device("cpu"), str(root))
        card = Resident({model: SDPipeline(model, device=device, dtype=torch.float32,
                                           model_root_dir=str(root))
                         for model in TINY_EDIT_MODELS})
        lat = size // 2

        def noise(seed):
            return torch.randn((1, 4, lat, lat), generator=torch.Generator().manual_seed(seed))

        def noise_fn(kind, i, shape):
            return noise(100 + i + 1000 * (kind == "keep"))

        common = dict(prompt="make it snow", negative_prompt="blurry", num_inference_steps=steps,
                      guidance_scale=6.0, latents=noise(7), noise_fn=noise_fn)
        jobs = [
            ("test/tiny-pix2pix", "pix2pix", dict(image=start_image(size))),
            ("test/tiny-xl-pix2pix", "pix2pix",
             dict(image=start_image(size), image_guidance_scale=2.0,
                  scheduler_type="EulerAncestralDiscreteScheduler")),
            ("test/tiny-xl", "txt2img",
             dict(height=size, width=size, refiner={"model_name": "test/tiny-xl-refiner"},
                  refiner_latents=noise(8), refiner_noise_fn=noise_fn)),
            ("test/tiny-sd", "txt2img", dict(height=size, width=size)),
        ]
        result = {}
        for model, mode, job in jobs:
            want, _ = cpu.get_pipeline(model).run(registry=cpu, **common, **job)
            got, config = card.get_pipeline(model).run(registry=card, **common, **job)
            diff = int(np.abs(got[0].astype(np.int16) - want[0].astype(np.int16)).max())
            what = f"{model} {mode}" + (" + refiner" if "refiner" in job else "")
            check(config["mode"] == mode, f"{what}: mode {config['mode']}")
            check(config["weights"] == "checkpoint", f"{what}: weights {config['weights']}")
            check(diff <= 2, f"{what}: card vs CPU pixel diff {diff} > 2")
            if "refiner" in job:
                check("refiner_s" in config["timings"], f"{what}: no refiner_s")
                for reg in (cpu, card):
                    check(reg.get_pipeline("test/tiny-xl-refiner").weights_source
                          == "checkpoint", "the tiny refiner did not load its checkpoint")
            result[what] = {"mode": mode, "max_pixel_diff": diff}
            log(f"[tiny] {what} {size}^2 f32 from safetensors"
                + (" (legacy layout)" if model == "test/tiny-sd" else "")
                + f", {device} vs CPU: max pixel diff {diff}/255 (bound 2/255)")
        check(len(cpu.resident_models()) == 4, f"the registry holds {cpu.resident_models()}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return result


def start_image(size: int):
    """A smooth procedural RGB image (compresses far under the 3 MiB input
    cap at 1024^2, unlike noise)."""
    import numpy as np
    from PIL import Image

    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    rgb = np.stack([0.5 + 0.5 * np.sin(6.0 * xx + 2.0 * yy),
                    0.5 + 0.5 * np.cos(4.0 * yy - 3.0 * xx),
                    0.25 + 0.5 * xx * yy], axis=-1)
    return Image.fromarray((255 * rgb).astype(np.uint8))


def photo_image(size: int):
    """A photo-like procedural RGB image with edges for canny to find:
    seeded discs of colour over stripes (a JPEG of it stays under the input
    cap at 1024^2)."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(17)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    img = np.full((size, size, 3), 90.0, np.float32)
    for _ in range(12):
        cx, cy, r = rng.uniform(0, size, 2).tolist() + [rng.uniform(size / 16, size / 4)]
        img[(xx - cx) ** 2 + (yy - cy) ** 2 < r * r] = rng.uniform(0, 255, 3)
    img += 30 * np.sin(xx / (size / 40))[..., None] * np.array([1.0, 0.5, 0.2], np.float32)
    return Image.fromarray(np.clip(img, 0, 255).astype(np.uint8))


def qr_image(size: int):
    """Black and white modules with three finder squares, as a QR code's
    (the `qrcode` package is not on the card's machine)."""
    import numpy as np
    from PIL import Image

    cells = np.random.default_rng(29).random((29, 29)) > 0.5
    for r, c in ((0, 0), (0, 22), (22, 0)):
        cells[r:r + 7, c:c + 7] = True
        cells[r + 1:r + 6, c + 1:c + 6] = False
        cells[r + 2:r + 5, c + 2:c + 5] = True
    modules = np.pad(cells, 4)
    image = Image.fromarray(np.where(modules, 0, 255).astype(np.uint8)).convert("RGB")
    return image.resize((size, size), Image.NEAREST)


def half_mask(size: int):
    """White (repaint) over the right half, black (keep) over the left."""
    from PIL import Image

    mask = Image.new("L", (size, size), 0)
    mask.paste(255, (size // 2, 0, size, size))
    return mask


def image_bytes(image, fmt: str) -> bytes:
    buf = io.BytesIO()
    image.save(buf, fmt, **({"quality": 90} if fmt == "JPEG" else {}))
    return buf.getvalue()


def tiny_image_checks(device: str = "cuda", size: int = 64, steps: int = 4) -> dict:
    """Phase 4 for the image modes: the tiny pipelines in f32 on `device`
    against the same weights on the CPU, with the same initial latents and
    injected step and keep noise; every SD solver wire name (the
    registry's, without Flux's flow-matching names) runs one 4-channel
    inpaint job. On `device`, each 4-channel inpaint job's
    latents that reach the decode must equal the encoded clean latents bit
    for bit where the mask keeps the image (captured by wrapping the
    pipeline's encode_image and decode)."""
    import numpy as np

    from chiaswarm_tpu_torch.pipelines.stable_diffusion import SDPipeline, _mask_to_latent_array
    from chiaswarm_tpu_torch.schedulers import (
        SCHEDULERS,
        DDPMWuerstchenScheduler,
        FlowMatchEulerScheduler,
    )

    pairs = {}
    for model in ("test/tiny-xl", "test/tiny-xl-inpaint"):
        cpu = SDPipeline(model, device="cpu")
        weights = {"unet": cpu.unet.state_dict(),
                   "text": [e.state_dict() for e in cpu.text_encoders],
                   "vae": cpu.vae.state_dict()}
        pairs[model] = (cpu, SDPipeline(model, device=device, dtype=torch.float32,
                                        weights=weights))
    lat = size // pairs["test/tiny-xl"][0].latent_factor
    latents = torch.randn((1, 4, lat, lat), generator=torch.Generator().manual_seed(7))

    def noise_fn(kind, i, shape):
        seed = 1000 * (kind == "keep") + i
        return torch.randn(shape, generator=torch.Generator().manual_seed(seed))

    image, mask = start_image(size), half_mask(size)
    common = dict(prompt="a red cube", num_inference_steps=steps, latents=latents,
                  noise_fn=noise_fn, image=image)
    jobs = [("img2img", "test/tiny-xl",
             dict(scheduler_type="EulerAncestralDiscreteScheduler", strength=0.75)),
            ("inpaint", "test/tiny-xl",
             dict(scheduler_type="DPMSolverMultistepScheduler", mask_image=mask)),
            ("inpaint9", "test/tiny-xl-inpaint",
             dict(scheduler_type="UniPCMultistepScheduler", mask_image=mask))]
    jobs += [("inpaint", "test/tiny-xl", dict(scheduler_type=name, mask_image=mask,
                                              strength=0.6))
             # the SD solvers: Flux's and Stable Cascade's schedulers serve their families
             for name, cls in SCHEDULERS.items()
             if cls not in (FlowMatchEulerScheduler, DDPMWuerstchenScheduler)]
    captured = {}

    def capture(name, fn):
        """fn, recording what it returns ("clean") or its input ("final")."""
        def wrapped(*args):
            out = fn(*args)
            captured[name] = out if name == "clean" else args[0]
            return out
        return wrapped

    result = {}
    for mode, model, job in jobs:
        cpu, card = pairs[model]
        captured.clear()
        if mode == "inpaint":
            card.encode_image = capture("clean", card.encode_image)
            card.decode = capture("final", card.decode)
        try:
            want, _ = cpu.run(**common, **job)
            got, config = card.run(**common, **job)
        finally:
            card.__dict__.pop("encode_image", None)
            card.__dict__.pop("decode", None)
        what = f"{model} {mode} {job['scheduler_type']} strength {job.get('strength', 0.75)}"
        diff = int(np.abs(got[0].astype(np.int16) - want[0].astype(np.int16)).max())
        row = {"mode": config["mode"], "max_pixel_diff": diff}
        check(config["mode"] == mode, f"{what}: mode {config['mode']}")
        check(diff <= 2, f"{what}: card vs CPU pixel diff {diff} > 2")
        if mode == "inpaint":
            clean, final = captured["clean"].expand_as(captured["final"]), captured["final"]
            factor = size // lat
            keep = torch.from_numpy(_mask_to_latent_array(mask, size, size, factor)[..., 0] == 0)
            keep = keep.to(final.device).expand_as(final)
            row["kept_equal"] = bool(torch.equal(final[keep], clean[keep]))
            row["kept_values"] = int(keep.sum())
            check(row["kept_values"] > 0 and row["kept_equal"],
                  f"{what}: the kept latents differ from the clean latents on {device}")
            check(not torch.equal(final[~keep], clean[~keep]),
                  f"{what}: the repainted latents equal the clean latents")
        result[what] = row
        log(f"[tiny] {what} {size}^2 f32, {device} vs CPU: max pixel diff {diff}/255 "
            f"(bound 2/255)" + (f"; kept latents equal the clean latents bit for bit "
                                f"({row['kept_values']} values)" if "kept_equal" in row else ""))
    return result


# --- adapters: files written from seeded tensors (phases 4 and 5) ---

# the Linear modules a kohya or PEFT LoRA of SD covers: every attention
# projection and the feed-forward of each transformer block, and each
# transformer model's proj_in / proj_out; in a text encoder, every
# attention projection and both MLP layers
LORA_UNET_SUFFIXES = ("attn1.to_q", "attn1.to_k", "attn1.to_v", "attn1.to_out.0",
                      "attn2.to_q", "attn2.to_k", "attn2.to_v", "attn2.to_out.0",
                      "ff.net.0.proj", "ff.net.2", "proj_in", "proj_out")
LORA_TE_SUFFIXES = ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
                    "self_attn.out_proj", "mlp.fc1", "mlp.fc2")


def write_lora(path: Path, pipe, layout: str, rank: int, alpha: float | None = None,
               te_rank: int = 0, seed: int = 0, conv_proj: bool = False) -> dict:
    """A LoRA over `pipe`'s modules from seeded tensors, as fp16
    safetensors in `layout`: "kohya" (lora_unet_ / lora_te[1|2]_ names in
    underscores, lora_down / lora_up, an `.alpha` per module when `alpha` is
    given) or "peft" (unet. / text_encoder[_2]. dotted names, lora_A /
    lora_B). The UNet's LORA_UNET_SUFFIXES modules at `rank`; with
    `te_rank`, each text encoder's LORA_TE_SUFFIXES at that rank. With
    `conv_proj`, proj_in / proj_out are written in SD 1.x's 1x1-conv shapes
    [r, in, 1, 1] and [out, r, 1, 1]. A ~ N(0, 1/in), B ~ N(0, 1/16r).
    -> {"name", "modules", "conv", "bytes"}."""
    import numpy as np
    from safetensors.numpy import save_file
    from torch import nn

    rng = np.random.default_rng(seed)
    state, conv = {}, 0
    parts = [(pipe.unet, "lora_unet_", "unet.", LORA_UNET_SUFFIXES, rank)]
    if te_rank:
        for i, enc in enumerate(pipe.text_encoders):
            kohya = "lora_te_" if len(pipe.text_encoders) == 1 else f"lora_te{i + 1}_"
            parts.append((enc, kohya, "text_encoder" + ("_2." if i else "."), LORA_TE_SUFFIXES,
                          te_rank))
    for module, kohya, peft, suffixes, r in parts:
        for name, m in module.named_modules():
            if not (isinstance(m, nn.Linear) and name.endswith(suffixes)):
                continue
            out_f, in_f = m.weight.shape
            a = (rng.standard_normal((r, in_f)) / np.sqrt(in_f)).astype(np.float16)
            b = (rng.standard_normal((out_f, r)) / (4 * np.sqrt(r))).astype(np.float16)
            if conv_proj and name.endswith(("proj_in", "proj_out")):
                a, b = a[:, :, None, None], b[:, :, None, None]
                conv += 1
            if layout == "kohya":
                base = kohya + name.replace(".", "_")
                state[f"{base}.lora_down.weight"], state[f"{base}.lora_up.weight"] = a, b
                if alpha is not None:
                    state[f"{base}.alpha"] = np.asarray(alpha, np.float16)
            else:
                state[f"{peft}{name}.lora_A.weight"], state[f"{peft}{name}.lora_B.weight"] = a, b
    path.parent.mkdir(parents=True, exist_ok=True)
    save_file(state, str(path))
    modules = sum(k.endswith((".lora_down.weight", ".lora_A.weight")) for k in state)
    return {"name": path.name, "modules": modules, "conv": conv, "bytes": path.stat().st_size}


def write_ti(path: Path, pipe, fmt: str, token: str = "<smoke-style>", vectors: int = 2,
             seed: int = 0) -> int:
    """A textual inversion from seeded vectors (N(0, 0.05^2)) as safetensors:
    "diffusers" ({token: [k, D]} at the first encoder's width), "kohya"
    ({"emb_params": ...}) or "dual" (SDXL's {"clip_l": [k, D1], "clip_g":
    [k, D2]} at the two encoders' widths). -> file bytes."""
    import numpy as np
    from safetensors.numpy import save_file

    rng = np.random.default_rng(seed)
    dims = [e.config.hidden_size for e in pipe.text_encoders]

    def vec(dim):
        return (0.05 * rng.standard_normal((vectors, dim))).astype(np.float32)

    state = {"diffusers": lambda: {token: vec(dims[0])},
             "kohya": lambda: {"emb_params": vec(dims[0])},
             "dual": lambda: {"clip_l": vec(dims[0]), "clip_g": vec(dims[-1])}}[fmt]()
    path.parent.mkdir(parents=True, exist_ok=True)
    save_file(state, str(path))
    return path.stat().st_size


def write_vae(model_dir: Path, pipe, seed: int, subfolder: str = "") -> int:
    """A VAE of `pipe`'s VAE config with seeded random weights, as fp16
    safetensors under `model_dir[/subfolder]` (sd-vae-ft-mse ships its file
    at the top of the repo, an SD model directory under vae/). -> bytes."""
    from safetensors.torch import save_file

    from chiaswarm_tpu_torch.models.vae import AutoencoderKL
    from chiaswarm_tpu_torch.weights import random_init_

    with torch.device("meta"):
        vae = AutoencoderKL(pipe.vae.config)
    vae = vae.to_empty(device=pipe.device).float()
    random_init_(vae, torch.Generator(device=pipe.device).manual_seed(seed))
    state = {k: v.detach().to("cpu", torch.float16).contiguous()
             for k, v in vae.state_dict().items()}
    del vae
    folder = model_dir / subfolder
    folder.mkdir(parents=True, exist_ok=True)
    path = folder / "diffusion_pytorch_model.safetensors"
    save_file(state, str(path))
    return path.stat().st_size


def write_controlnet(model_dir: Path, pipe, seed: int) -> int:
    """A ControlNet of `pipe`'s UNet config (the control embedding sized to
    its VAE's factor) with seeded random weights in every conv, the zero
    convs and the embedding's output conv too (a branch of zeros would add
    nothing and prove nothing), as fp16 diffusers-layout safetensors under
    `model_dir` (a published ControlNet's folder holds its file at the
    top). -> bytes."""
    from safetensors.torch import save_file

    from chiaswarm_tpu_torch.models.controlnet import ControlNetModel
    from chiaswarm_tpu_torch.weights import random_init_

    with torch.device("meta"):
        branch = ControlNetModel(pipe.unet.config, cond_downscale=pipe.latent_factor)
    branch = branch.to_empty(device=pipe.device).float()
    random_init_(branch, torch.Generator(device=pipe.device).manual_seed(seed))
    state = {k: v.detach().to("cpu", torch.float16).contiguous()
             for k, v in branch.state_dict().items()}
    del branch
    model_dir.mkdir(parents=True, exist_ok=True)
    path = model_dir / "diffusion_pytorch_model.safetensors"
    save_file(state, str(path))
    return path.stat().st_size


def tiny_adapter_checks(device: str = "cuda", size: int = 64, steps: int = 4) -> dict:
    """Phase 4 for adapters: the tiny pipelines in f32 on `device` against
    the same weights on the CPU, every adapter written under a temporary
    root, with the same injected noise; the decoded images must agree
    within 2/255. Jobs: test/tiny-xl with a kohya adapter over the UNet and
    both text encoders (`.alpha` per module) at lora_scale 0.8 given as
    cross_attention_kwargs.scale; test/tiny-sd with a PEFT adapter whose
    proj_in / proj_out factors are 1x1-conv shaped (skipped, the same count
    on both devices); a dual-encoder textual inversion on tiny-xl and a
    diffusers one on tiny-sd; a custom VAE on a tiny-sd img2img job. Each
    adapter job's image must differ from the same job without it."""
    import shutil
    import tempfile

    import numpy as np

    from chiaswarm_tpu_torch.loras import resolve_lora
    from chiaswarm_tpu_torch.pipelines.stable_diffusion import SDPipeline

    root = Path(tempfile.mkdtemp(prefix="chip-smoke-adapters-"))
    loras = root / "loras"
    try:
        pairs = {}
        for model in ("test/tiny-xl", "test/tiny-sd"):
            cpu = SDPipeline(model, device="cpu", model_root_dir=str(root),
                             lora_root_dir=str(loras))
            weights = {"unet": cpu.unet.state_dict(),
                       "text": [e.state_dict() for e in cpu.text_encoders],
                       "vae": cpu.vae.state_dict()}
            pairs[model] = (cpu, SDPipeline(model, device=device, dtype=torch.float32,
                                            weights=weights, model_root_dir=str(root),
                                            lora_root_dir=str(loras)))
        xl, sd = pairs["test/tiny-xl"][0], pairs["test/tiny-sd"][0]
        kohya = write_lora(loras / "tiny-xl-kohya.safetensors", xl, "kohya", rank=4, alpha=2.0,
                           te_rank=2, seed=11)
        peft = write_lora(loras / "tiny-sd-peft.safetensors", sd, "peft", rank=4, seed=12,
                          conv_proj=True)
        write_ti(loras / "tiny-xl-dual.safetensors", xl, "dual", seed=13)
        write_ti(loras / "tiny-sd-ti.safetensors", sd, "diffusers", seed=14)
        write_vae(root / "test/tiny-vae", sd, seed=15)
        lat = size // 2

        def noise(seed):
            return torch.randn((1, 4, lat, lat), generator=torch.Generator().manual_seed(seed))

        def noise_fn(kind, i, shape):
            return noise(100 + i + 1000 * (kind == "keep"))

        common = dict(negative_prompt="blurry", num_inference_steps=steps, guidance_scale=6.0,
                      height=size, width=size, latents=noise(7), noise_fn=noise_fn,
                      scheduler_type="EulerAncestralDiscreteScheduler")
        jobs = [
            ("test/tiny-xl", "kohya LoRA (UNet, te1, te2, alpha) at scale 0.8",
             dict(prompt="a red cube",
                  lora=resolve_lora("tiny-xl-kohya.safetensors", str(loras)),
                  cross_attention_kwargs={"scale": 0.8})),
            ("test/tiny-sd", "PEFT LoRA with conv-shaped proj_in / proj_out",
             dict(prompt="a red cube", lora=resolve_lora("tiny-sd-peft.safetensors", str(loras)))),
            ("test/tiny-xl", "dual-encoder textual inversion",
             dict(prompt="a <tiny-xl-dual> cube", textual_inversion="tiny-xl-dual.safetensors")),
            ("test/tiny-sd", "diffusers textual inversion",
             dict(prompt="a <smoke-style> cube", textual_inversion="tiny-sd-ti.safetensors")),
            ("test/tiny-sd", "custom VAE, img2img",
             dict(prompt="a red cube", vae="test/tiny-vae", image=start_image(size),
                  strength=0.75)),
        ]
        result = {}
        for model, what, job in jobs:
            cpu, card = pairs[model]
            want, want_cfg = cpu.run(**common, **job)
            got, config = card.run(**common, **job)
            plain = {k: v for k, v in job.items()
                     if k not in ("lora", "cross_attention_kwargs", "textual_inversion", "vae")}
            base, _ = card.run(**common, **plain)
            diff = int(np.abs(got[0].astype(np.int16) - want[0].astype(np.int16)).max())
            moved = int(np.abs(got[0].astype(np.int16) - base[0].astype(np.int16)).max())
            row = {"max_pixel_diff": diff, "changed_by_adapter": moved,
                   "lora_modules": config.get("lora_modules")}
            check(diff <= 2, f"{model} {what}: card vs CPU pixel diff {diff} > 2")
            check(moved > 2, f"{model} {what}: the adapter left the image unchanged ({moved})")
            if "lora" in job:
                check(config["lora_mode"] == "delta", f"{model} {what}: {config['lora_mode']}")
                check(config["lora_modules"] == want_cfg["lora_modules"],
                      f"{model} {what}: modules {config['lora_modules']} on {device}, "
                      f"{want_cfg['lora_modules']} on the CPU")
                written = kohya if "kohya" in what else peft
                check(config["lora_modules"] == {"matched": written["modules"] - written["conv"],
                                                 "unmatched": written["conv"]},
                      f"{model} {what}: modules {config['lora_modules']}, written {written}")
            result[f"{model} {what}"] = row
            log(f"[tiny] {model} {what} {size}^2 f32, {device} vs CPU: max pixel diff {diff}/255 "
                f"(bound 2/255); the adapter moves the image by up to {moved}/255"
                + (f"; modules {config['lora_modules']}" if "lora" in job else ""))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return result


def tiny_batched_checks(device: str = "cuda", size: int = 64, steps: int = 4) -> dict:
    """Phase 4 for coalesced passes: `run_batched` of the tiny pipelines in
    f32 on `device` against the same weights on the CPU, with the same
    injected per-row noise, each image within 2/255: a test/tiny-sd txt2img
    group of counts (1, 2, 1); a test/tiny-xl group of 3 rows padded to 4;
    a test/tiny-xl img2img group with two distinct start images (strength
    0.6); a test/tiny-xl group with two LoRAs (one over the text encoders
    too) and a plain row, each adapter row moved by its adapter and the
    plain row what a pass without adapters gives, bit for bit."""
    import shutil
    import tempfile

    import numpy as np
    from PIL import Image

    from chiaswarm_tpu_torch.loras import resolve_lora
    from chiaswarm_tpu_torch.pipelines.common import pad_bucket
    from chiaswarm_tpu_torch.pipelines.stable_diffusion import SDPipeline

    root = Path(tempfile.mkdtemp(prefix="chip-smoke-batched-"))
    loras = root / "loras"
    try:
        pairs = {}
        for model in ("test/tiny-sd", "test/tiny-xl"):
            cpu = SDPipeline(model, device="cpu", lora_root_dir=str(loras))
            weights = {"unet": cpu.unet.state_dict(),
                       "text": [e.state_dict() for e in cpu.text_encoders],
                       "vae": cpu.vae.state_dict()}
            pairs[model] = (cpu, SDPipeline(model, device=device, dtype=torch.float32,
                                            weights=weights, lora_root_dir=str(loras)))
        xl = pairs["test/tiny-xl"][0]
        write_lora(loras / "tiny-xl-a.safetensors", xl, "kohya", rank=4, alpha=2.0, te_rank=2,
                   seed=41)
        write_lora(loras / "tiny-xl-b.safetensors", xl, "peft", rank=2, seed=42)
        second = start_image(size).transpose(Image.Transpose.FLIP_LEFT_RIGHT)
        lat = size // 2
        groups = [
            ("test/tiny-sd", "txt2img, counts (1, 2, 1)", {}, [
                dict(prompt="a red cube", seed=1), dict(prompt="a blue ball", seed=2,
                                                        num_images_per_prompt=2),
                dict(prompt="a green cone", seed=3)]),
            ("test/tiny-xl", "3 rows padded to 4", {}, [
                dict(prompt="a boat", seed=4), dict(prompt="a ship", seed=5),
                dict(prompt="a raft", seed=6)]),
            ("test/tiny-xl", "img2img, two start images", {"strength": 0.6}, [
                dict(prompt="a castle", seed=7, image=start_image(size)),
                dict(prompt="a tower", seed=8, image=second)]),
            ("test/tiny-xl", "two LoRAs and a plain row", {}, [
                dict(prompt="a cat", seed=9, lora=resolve_lora("tiny-xl-a.safetensors",
                                                               str(loras)), lora_scale=0.8),
                dict(prompt="a dog", seed=10),
                dict(prompt="a fox", seed=11, lora=resolve_lora("tiny-xl-b.safetensors",
                                                                str(loras)), lora_scale=0.5)]),
        ]
        result = {}
        for model, what, extra, requests in groups:
            cpu, card = pairs[model]
            padded = pad_bucket(sum(r.get("num_images_per_prompt", 1) for r in requests))
            shape = (padded, 4, lat, lat)
            requests = [dict(r, negative_prompt="blurry") for r in requests]
            common = dict(num_inference_steps=steps,
                          guidance_scale=6.0, height=size, width=size,
                          scheduler_type="EulerAncestralDiscreteScheduler",
                          latents=torch.randn(shape, generator=torch.Generator().manual_seed(7)),
                          noise_fn=lambda kind, i, shape: torch.randn(
                              shape, generator=torch.Generator().manual_seed(100 + i)), **extra)
            want = cpu.run_batched([dict(r) for r in requests], **common)
            got = card.run_batched([dict(r) for r in requests], **common)
            diff = max(int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max())
                       for (images, _), (ref, _) in zip(got, want) for a, b in zip(images, ref))
            row = {"max_pixel_diff": diff, "padded_rows": got[0][1]["padded_rows"],
                   "batch_rows": [c["batch_rows"] for _, c in got]}
            check(diff <= 2, f"{model} {what}: card vs CPU pixel diff {diff} > 2")
            check([c["batch_rows"] for _, c in got] == [c["batch_rows"] for _, c in want]
                  and row["padded_rows"] == padded, f"{model} {what}: rows {row}")
            if "LoRA" in what:
                plain = card.run_batched([{k: v for k, v in r.items()
                                           if k not in ("lora", "lora_scale")}
                                          for r in requests], **common)
                moved = [int(np.abs(a[0].astype(np.int16) - b[0].astype(np.int16)).max())
                         for (a, _), (b, _) in zip(got, plain)]
                row["changed_by_adapter"] = moved
                check(moved[0] > 2 and moved[2] > 2, f"{model} {what}: adapters moved {moved}")
                check(moved[1] == 0, f"{model} {what}: the plain row moved by {moved[1]}")
                check([c.get("lora_mode") for _, c in got] == ["delta", None, "delta"],
                      f"{model} {what}: lora modes {[c.get('lora_mode') for _, c in got]}")
            result[f"{model} {what}"] = row
            log(f"[tiny] coalesced {model} {what} {size}^2 f32, {device} vs CPU: max pixel diff "
                f"{diff}/255 (bound 2/255); rows {row['batch_rows']} padded to {padded}"
                + (f"; adapters move their rows by {row['changed_by_adapter']}/255"
                   if "changed_by_adapter" in row else ""))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return result


# --- phase 5 ---

def decode_artifact(artifact: dict):
    import numpy as np
    from PIL import Image

    blob = base64.b64decode(artifact["blob"])
    check(hashlib.sha256(blob).hexdigest() == artifact["sha256_hash"], "artifact sha256 mismatch")
    image = np.asarray(Image.open(io.BytesIO(blob)).convert("RGB"))
    base64.b64decode(artifact["thumbnail"])
    return image


def serve_main_path(smi: str, device: str = "cuda", model: str = SDXL, size: int = SIZE,
                    steps: int = STEPS, registry=None):
    """The txt2img jobs and the echo job -> ({kernel: (launches, {shape:
    launches})}, served, registry)."""
    from chiaswarm_tpu_torch.fake_hive import FakeHive
    from chiaswarm_tpu_torch.ops.flash_attention import COUNTER as FA_COUNTER
    from chiaswarm_tpu_torch.ops.group_norm import COUNTER as GN_COUNTER
    from chiaswarm_tpu_torch.registry import Registry
    from chiaswarm_tpu_torch.settings import Settings
    from chiaswarm_tpu_torch.worker import Worker

    hive = FakeHive(token="smoke-token")
    try:
        # one job a pass, as before batching (the batched path is its own)
        settings = Settings(sdaas_token="smoke-token", sdaas_uri=hive.uri,
                            worker_name="chip-smoke", model_root_dir=str(ROOT / ".no-models"),
                            max_coalesce=1)
        registry = registry or Registry(torch.device(device), settings.model_root_dir)
        t0 = time.perf_counter()
        pipe = registry.get_pipeline(model, allow_random_init=True)
        log(f"[serve] {model} resident in {time.perf_counter() - t0:.1f}s "
            f"(seeded random weights, {pipe.dtype}); "
            f"{torch.cuda.memory_allocated() / 2**30 if device == 'cuda' else 0:.1f} GiB "
            "allocated")
        worker = Worker(settings=settings, device=device, registry=registry, poll_seconds=0.05,
                        heartbeat_seconds=HEARTBEAT_SECONDS)
        jobs = [{"id": f"txt2img-{i}", "workflow": "txt2img", "model_name": model,
                 "prompt": f"a lighthouse on a cliff at dusk, study {i}",
                 "negative_prompt": "blurry", "height": size, "width": size,
                 "num_inference_steps": steps, "guidance_scale": 7.0, "seed": 1000 + i,
                 "content_type": "image/png",
                 "parameters": {"scheduler_type": "DPMSolverMultistepScheduler"}}
                for i in range(N_JOBS)]
        jobs.append({"id": "echo-0", "workflow": "echo", "model_name": "none",
                     "prompt": "chip smoke"})
        hive.enqueue(*jobs)

        FA_COUNTER.reset()
        GN_COUNTER.reset()
        t0 = time.perf_counter()
        asyncio.run(worker.run(max_jobs=len(jobs)))
        served_s = time.perf_counter() - t0
        launches = {
            "flash_attention": (FA_COUNTER.launches, dict(FA_COUNTER.shapes)),
            "group_norm": (GN_COUNTER.launches, dict(GN_COUNTER.shapes)),
        }
        routes = dict(FA_COUNTER.routes)
        results = hive.wait_for_results(len(jobs), timeout=30)
        check(hive.auth_failures == 0, "the hive refused the worker's bearer token")
        poll = hive.polls[0]
        for key in ("worker_version", "worker_name", "gpu", "memory", "chips", "hbm_gb"):
            check(key in poll, f"capability advertisement lacks {key}")
    finally:
        hive.close()

    by_id = {r["id"]: r for r in results}
    served = {"served_s": served_s, "jobs": {}}
    check(set(by_id) == {j["id"] for j in jobs}, f"results for {sorted(by_id)}")
    for job in jobs:
        r = by_id[job["id"]]
        check(not r.get("fatal_error"), f"{job['id']}: fatal envelope {r['pipeline_config']}")
        check("error" not in r["pipeline_config"], f"{job['id']}: {r['pipeline_config']}")
        check(r["worker_version"] and "primary" in r["artifacts"], f"{job['id']}: envelope shape")
        image = decode_artifact(r["artifacts"]["primary"])
        cfg = r["pipeline_config"]
        if job["workflow"] == "echo":
            log(f"[serve] {job['id']}: echo envelope ok, image {image.shape}")
            continue
        check(image.shape == (size, size, 3), f"{job['id']}: image {image.shape}")
        check(int(image.max()) != int(image.min()), f"{job['id']}: constant image")
        check(cfg["latents"]["finite"], f"{job['id']}: non-finite latents")
        t = cfg["timings"]
        served["jobs"][job["id"]] = {"timings": t, "latents": cfg["latents"]}
        log(f"[serve] {job['id']} on {smi}: job {t['job_s']:.3f}s = text_encode "
            f"{t['text_encode_s']:.3f}s + denoise {t['denoise_s']:.3f}s "
            f"(UNet step {t['unet_step_ms']:.1f} ms at CFG batch 2) + decode "
            f"{t['decode_s']:.3f}s + artifacts {t['encode_artifacts_s']:.3f}s; "
            f"latents |max| {cfg['latents']['absmax']:.3g}; pixels "
            f"{int(image.min())}..{int(image.max())} mean {float(image.mean()):.1f}")
    counts = {k: v[0] for k, v in launches.items()}
    log(f"[serve] {len(jobs)} jobs served in {served_s:.1f}s; kernel launches during "
        f"the served jobs: {json.dumps(counts)}")
    for name, count in counts.items():
        check(count > 0, f"{name} was never launched on the main path")
    fma = {k: n for k, n in routes.items() if k[0] == "fma" and k[1] == torch.bfloat16}
    check(not fma, f"bf16 attention took the FMA kernel on the main path: {fma}")
    return launches, served, registry


# kernel launches of one VAE encode and one VAE decode (one attention
# call and 22 or 30 GroupNorm calls each, at any canvas)
ENCODE_LAUNCHES = {"flash_attention": 1, "group_norm": 22}
DECODE_LAUNCHES = {"flash_attention": 1, "group_norm": 30}


def _snapshot(counters: dict) -> dict:
    return {name: (c.launches, Counter(c.shapes)) for name, c in counters.items()}


def serve_counted(smi: str, registry, jobs: list, per_call: dict, device: str = "cuda",
                  tag: str = "image", where: str = "image path",
                  hold: bool = True, cn_per_call: dict | None = None,
                  k_unet_per_call: dict | None = None,
                  checker_per_call: dict | None = None,
                  detector_launches: dict | None = None,
                  settings_kw: dict | None = None) -> tuple[dict, dict]:
    """Serve `jobs` [(kind, mode, job)] one at a time through the worker;
    a job's `start_image_uri` / `mask_image_uri` of "start" / "mask", and
    its ControlNet's `control_image_uri` of "photo" / "qr", is replaced by
    the smooth start image / half mask / photo-like image / QR-like image
    at the job's size, served by the fake hive. Each job's kernel launches
    are counted and held to its UNet calls x `per_call`[its model] {kernel:
    launches per UNet call} plus one VAE encode (a job with a start image)
    and one decode; for a job with a `refiner` the refiner's UNet calls x
    `per_call`[the refiner] plus its encode and decode; for a ControlNet
    job its branch calls (the loop indices from t_start in the guidance
    window, none at scale 0) x `cn_per_call`[the ControlNet], and for the
    QR chain its first stage's UNet calls and decode and the second
    stage's encode. A job with `upscale` (and the standalone upscale job,
    mode "upscale", whose model has no UNet calls) adds its upscaler's
    K-UNet calls (UPSCALE_STEPS, or the standalone job's steps) x
    `k_unet_per_call`, an encode and a decode; where the envelope says
    `latent-resize-fallback`, an encode and a decode alone. A job whose
    envelope says `nsfw_checked` adds one checker call, `checker_per_call`.
    Upscaled images are twice the job's size. A ControlNet job with a
    `preprocessor` adds its detector's launches, `detector_launches`[the
    preprocessor] (none where it has no entry); `settings_kw` overrides the
    worker's settings (the detectors' `model_root_dir`, the registry's
    unless given, `depth_model`, `pose_model`), and each job's
    `degraded_preprocessors` is kept in served["jobs"]. No bf16
    attention may take the FMA kernel -> ({kind:
    (1, {kernel: (launches, {shape: launches})})}, served), served["jobs"]
    with each image's sha256. With `hold` false the caller holds the
    launches itself (`hold_launches`)."""
    from chiaswarm_tpu_torch.external_resources import LIMITS
    from chiaswarm_tpu_torch.fake_hive import FakeHive
    from chiaswarm_tpu_torch.ops.flash_attention import COUNTER as FA_COUNTER
    from chiaswarm_tpu_torch.ops.group_norm import COUNTER as GN_COUNTER
    from chiaswarm_tpu_torch.settings import Settings
    from chiaswarm_tpu_torch.worker import Worker

    counters = {"flash_attention": FA_COUNTER, "group_norm": GN_COUNTER}
    hive = FakeHive(token="smoke-token")
    try:
        served_files = {}

        def served_uri(which: str, size: int) -> str:
            if (which, size) not in served_files:
                if which in ("start", "photo"):
                    data = image_bytes((start_image if which == "start" else photo_image)(size),
                                       "JPEG")
                    check(len(data) < LIMITS.max_bytes,
                          f"{which} image {len(data)} bytes over the input cap")
                    uri = hive.enqueue_file(f"{which}-{size}.jpg", data, "image/jpeg")
                elif which == "qr":
                    uri = hive.enqueue_file(f"qr-{size}.png", image_bytes(qr_image(size), "PNG"),
                                            "image/png")
                else:
                    uri = hive.enqueue_file(f"mask-{size}.png",
                                            image_bytes(half_mask(size), "PNG"), "image/png")
                served_files[(which, size)] = uri
            return served_files[(which, size)]

        settings = Settings(**{"sdaas_token": "smoke-token", "sdaas_uri": hive.uri,
                               "worker_name": "chip-smoke",
                               "model_root_dir": registry.model_root_dir,
                               "lora_root_dir": registry.lora_root_dir or Settings.lora_root_dir,
                               "max_coalesce": 1, **(settings_kw or {})})
        worker = Worker(settings=settings, device=device, registry=registry, poll_seconds=0.05,
                        heartbeat_seconds=HEARTBEAT_SECONDS)
        FA_COUNTER.reset()
        GN_COUNTER.reset()
        paths, before = {}, _snapshot(counters)
        t0 = time.perf_counter()
        for k, (kind, _, job) in enumerate(jobs):
            job = dict(job)
            for key in ("start_image_uri", "mask_image_uri"):
                if key in job:
                    job[key] = served_uri(job[key], job["height"])
            cn = job.get("parameters", {}).get("controlnet")
            if cn and cn.get("control_image_uri"):
                job["parameters"] = {**job["parameters"], "controlnet": {
                    **cn, "control_image_uri": served_uri(cn["control_image_uri"],
                                                          job["height"])}}
            hive.enqueue(job)
            asyncio.run(worker.run(max_jobs=k + 1))
            after = _snapshot(counters)
            paths[kind] = (1, {name: (after[name][0] - before[name][0],
                                      after[name][1] - before[name][1]) for name in counters})
            before = after
        served_s = time.perf_counter() - t0
        routes = dict(getattr(FA_COUNTER, "routes", {}))
        results = hive.wait_for_results(len(jobs), timeout=30)
        check(hive.auth_failures == 0, "the hive refused the worker's bearer token")
    finally:
        hive.close()

    by_id = {r["id"]: r for r in results}
    served = {"served_s": served_s, "jobs": {}, "routes": {str(k): n for k, n in routes.items()},
              "fma_bf16": {str(k): n for k, n in routes.items()
                           if k[0] == "fma" and k[1] == torch.bfloat16}}
    for kind, mode, job in jobs:
        r = by_id[job["id"]]
        check(not r.get("fatal_error"), f"{job['id']}: fatal envelope {r['pipeline_config']}")
        check("error" not in r["pipeline_config"], f"{job['id']}: {r['pipeline_config']}")
        image = decode_artifact(r["artifacts"]["primary"])
        cfg, t = r["pipeline_config"], r["pipeline_config"]["timings"]
        size = job["height"]
        standalone = mode == "upscale"
        upscale = bool(job.get("parameters", {}).get("upscale")) or standalone
        out = 2 * size if upscale else size
        check(cfg["mode"] == mode, f"{job['id']}: mode {cfg['mode']}, not {mode}")
        check(image.shape == (out, out, 3), f"{job['id']}: image {image.shape}")
        check(int(image.max()) != int(image.min()), f"{job['id']}: constant image")
        check(cfg["latents"]["finite"], f"{job['id']}: non-finite latents")
        steps = job["num_inference_steps"]
        unet_calls = 0 if standalone else steps - cfg.get("t_start", 0)
        counted = {name: launches for name, (launches, _) in paths[kind][1].items()}
        encodes = int("start_image_uri" in job)
        predicted = {name: unet_calls * per_call.get(job["model_name"], {}).get(name, 0)
                     + encodes * ENCODE_LAUNCHES[name] + DECODE_LAUNCHES[name]
                     for name in counted}
        k_unet_calls = 0
        if upscale:
            fallback = cfg.get("upscaler") == "latent-resize-fallback"
            k_unet_calls = 0 if fallback else steps if standalone else UPSCALE_STEPS
            for name in predicted:
                predicted[name] += (k_unet_calls * (k_unet_per_call or {}).get(name, 0)
                                    + (0 if standalone else ENCODE_LAUNCHES[name]
                                       + DECODE_LAUNCHES[name]))
        if cfg.get("nsfw_checked"):
            for name in predicted:
                predicted[name] += (checker_per_call or {}).get(name, 0)
        refiner = job.get("parameters", {}).get("refiner")
        refiner_calls = 0
        if refiner:
            # the refiner's img2img: t_start = int(steps * (1 - strength))
            strength = float(refiner.get("strength", 0.3))
            refiner_calls = steps - min(max(int(steps * (1.0 - strength)), 0), steps - 1)
            for name in predicted:
                predicted[name] += (refiner_calls * per_call[refiner["model_name"]][name]
                                    + ENCODE_LAUNCHES[name] + DECODE_LAUNCHES[name])
            check("refiner_s" in t, f"{job['id']}: no refiner_s in the timings")
        cn = job.get("parameters", {}).get("controlnet")
        branch_calls = stage1_calls = 0
        if cn:
            from chiaswarm_tpu_torch.pipelines.stable_diffusion import control_window

            cn_name = cn.get("controlnet_model_name", "lllyasviel/control_v11p_sd15_canny")
            t_start = cfg.get("t_start", 0)
            lo, hi = control_window(cn.get("control_guidance_start", 0.0),
                                    cn.get("control_guidance_end", 1.0), steps)
            if float(cn.get("controlnet_conditioning_scale", 1.0)) != 0.0:
                # the smoke's solvers step once per loop index, from t_start
                branch_calls = sum(lo <= i < hi for i in range(t_start, steps))
            check(cfg["controlnet"] == cn_name and cfg["controlnet_calls"] == branch_calls,
                  f"{job['id']}: controlnet {cfg.get('controlnet')}, "
                  f"{cfg.get('controlnet_calls')} branch calls, not {branch_calls}")
            if (cn.get("parameters") or {}).get("controlnet_prepipeline_type"):
                # the QR chain: a plain first stage, then the ControlNet
                # img2img stage encodes its upscaled image
                check(cfg.get("prepipeline") == "qr_two_stage", f"{job['id']}: no QR chain")
                stage1_calls = steps
                for name in predicted:
                    predicted[name] += (stage1_calls * per_call[job["model_name"]][name]
                                        + ENCODE_LAUNCHES[name] + DECODE_LAUNCHES[name])
            for name in predicted:
                predicted[name] += branch_calls * cn_per_call[cn_name][name]
            preprocessor = cn.get("preprocessor")
            if preprocessor:
                for name in predicted:
                    predicted[name] += (detector_launches or {}).get(preprocessor, {}).get(name, 0)
        rows = 3 if mode == "pix2pix" else 2
        served["jobs"][job["id"]] = {"kind": kind, "mode": cfg["mode"], "model": cfg["model"],
                                     "size": size, "output": out, "timings": t,
                                     "latents": cfg["latents"],
                                     "nsfw": cfg.get("nsfw"),
                                     "nsfw_checked": cfg.get("nsfw_checked"),
                                     "upscaler": cfg.get("upscaler"),
                                     "output_size": cfg.get("output_size"),
                                     "k_unet_calls": k_unet_calls,
                                     "weights": cfg["weights"], "unet_calls": unet_calls,
                                     "refiner_unet_calls": refiner_calls,
                                     "controlnet_calls": branch_calls,
                                     "prepipeline_unet_calls": stage1_calls,
                                     "image_guidance_scale": cfg.get("image_guidance_scale"),
                                     "preprocessor": (cn or {}).get("preprocessor"),
                                     "degraded_preprocessors": cfg.get("degraded_preprocessors"),
                                     "launches": counted, "predicted_launches": predicted,
                                     "adapter": {k: cfg[k] for k in ("lora_mode", "lora_scale",
                                                                   "lora_modules", "operand_cache")
                                                 if k in cfg},
                                     "pixels_sha256": hashlib.sha256(image.tobytes()).hexdigest()}
        log(f"[{tag}] {job['id']} ({cfg['mode']}, {cfg['scheduler']}, {cfg['model']}, "
            f"{size}^2" + (f" -> {out}^2" if upscale else "") + f", weights {cfg['weights']}) "
            f"on {smi}: job {t['job_s']:.3f}s = text_encode {t['text_encode_s']:.3f}s"
            + (f" + image_encode {t['image_encode_s']:.3f}s" if "image_encode_s" in t else "")
            + (f" + denoise {t['denoise_s']:.3f}s ({steps} K-UNet calls, step "
               f"{t['step_ms']:.1f} ms)" if standalone else
               f" + denoise {t['denoise_s']:.3f}s ({unet_calls} UNet calls, step "
               f"{t['unet_step_ms']:.1f} ms at CFG batch {rows})")
            + f" + decode {t['decode_s']:.3f}s"
            + (f" + upscale {t['upscale_s']:.3f}s ({k_unet_calls} K-UNet calls"
               + (f", step {t['upscale_step_ms']:.1f} ms" if "upscale_step_ms" in t else "")
               + (", latent-resize fallback" if cfg.get("upscaler") else "") + ")"
               if "upscale_s" in t else "")
            + (f" + safety check {t['safety_s']:.3f}s (nsfw {cfg['nsfw']})"
               if cfg.get("nsfw_checked") else "")
            + (f" + refiner {t['refiner_s']:.3f}s ({refiner_calls} UNet calls)"
               if refiner else "")
            + (f" + first stage {t['prepipeline_s']:.3f}s ({stage1_calls} UNet calls)"
               if stage1_calls else "")
            + f" + artifacts {t['encode_artifacts_s']:.3f}s; latents |max| "
            f"{cfg['latents']['absmax']:.3g}; pixels {int(image.min())}..{int(image.max())} "
            f"mean {float(image.mean()):.1f}")
        log(f"[{tag}] {job['id']} kernel launches: counted {json.dumps(counted)}, predicted "
            f"{json.dumps(predicted)} ({unet_calls} UNet calls x "
            f"{json.dumps(per_call.get(job['model_name'], {}))}"
            + (" + one encode" if encodes else "") + " + one decode"
            + (f" + {k_unet_calls} K-UNet calls x {json.dumps(k_unet_per_call)}"
               + ("" if standalone else " + one encode + one decode") if upscale else "")
            + (f" + one checker call {json.dumps(checker_per_call)}"
               if cfg.get("nsfw_checked") else "")
            + (f" + {refiner_calls} refiner UNet calls x "
               f"{json.dumps(per_call[refiner['model_name']])} + one encode + one decode"
               if refiner else "")
            + (f" + {stage1_calls} first-stage UNet calls + one encode + one decode"
               if stage1_calls else "")
            + (f" + {branch_calls} ControlNet calls x {json.dumps(cn_per_call[cn_name])}"
               if cn else "")
            + (f" + the {cn['preprocessor']} detector "
               f"{json.dumps((detector_launches or {}).get(cn['preprocessor'], {}))}"
               if cn and cn.get("preprocessor") else "") + ")")
    log(f"[{tag}] {len(jobs)} jobs served in {served_s:.1f}s; attention routes "
        + json.dumps({f"{r} {str(dt)[6:]} D={d}": n for (r, dt, d), n in routes.items()}))
    if hold:
        hold_launches(served, where)
    return paths, served


def hold_launches(served: dict, where: str) -> None:
    """Every served job launched both kernels, exactly as predicted, and no
    bf16 attention took the FMA kernel."""
    for job_id, job in served["jobs"].items():
        for name, count in job["launches"].items():
            check(count > 0, f"{name} was never launched on the {where}")
        check(job["launches"] == job["predicted_launches"],
              f"{job_id}: launches {job['launches']} != predicted {job['predicted_launches']}")
    check(not served["fma_bf16"],
          f"bf16 attention took the FMA kernel on the {where}: {served['fma_bf16']}")


def serve_image_path(smi: str, registry, unet_launches: dict, device: str = "cuda",
                     model: str = SDXL, inpaint_model: str = SDXL_INPAINT, size: int = SIZE,
                     steps: int = STEPS) -> tuple[dict, dict]:
    """Phase 5, image path: img2img, 4-channel inpaint and 9-channel inpaint
    through the worker, their start image and mask served by the fake hive.
    `unet_launches` {kernel: launches per UNet call} predicts each job's
    launches -> ({job kind: (1, {kernel: (launches, {shape: launches})})},
    served)."""
    t0 = time.perf_counter()
    registry.get_pipeline(inpaint_model, allow_random_init=True)
    log(f"[image] {inpaint_model} resident in {time.perf_counter() - t0:.1f}s beside "
        f"{model}; {torch.cuda.memory_allocated() / 2**30 if device == 'cuda' else 0:.1f} "
        "GiB allocated")
    common = {"prompt": "a lighthouse on a cliff at dusk, repainted",
              "negative_prompt": "blurry", "height": size, "width": size,
              "num_inference_steps": steps, "guidance_scale": 7.0,
              "content_type": "image/png", "start_image_uri": "start"}
    jobs = [
        ("img2img", "img2img", {**common, "id": "img2img-0", "workflow": "img2img",
                                "model_name": model, "strength": 0.75, "seed": 2000,
                                "parameters": {"scheduler_type": "EulerAncestralDiscreteScheduler",
                                               "large_model": True}}),
        ("inpaint", "inpaint", {**common, "id": "inpaint-0", "workflow": "inpaint",
                                "model_name": model, "strength": 1.0, "seed": 2001,
                                "mask_image_uri": "mask",
                                "parameters": {"scheduler_type": "DDIMScheduler",
                                               "large_model": True}}),
        ("inpaint9", "inpaint9", {**common, "id": "inpaint9-0", "workflow": "inpaint",
                                  "model_name": inpaint_model, "seed": 2002,
                                  "mask_image_uri": "mask",
                                  "parameters": {"scheduler_type": "UniPCMultistepScheduler",
                                                 "large_model": True}}),
    ]
    return serve_counted(smi, registry, jobs, {model: unet_launches,
                                               inpaint_model: unet_launches}, device)


# kernel launches of one SD 1.x or SD 2.x UNet call: 32 attention (16
# transformer layers, one self- and one cross-attention each) and 61
# GroupNorm
SD_UNET_LAUNCHES = {"flash_attention": 32, "group_norm": 61}


def serve_sd_path(smi: str, registry, device: str = "cuda", sd15: str = SD15,
                  sd15_inpaint: str = SD15_INPAINT, sd21: str = SD21, size15: int = 512,
                  size21: int = 768, steps: int = STEPS) -> tuple[dict, dict]:
    """Phase 5, SD 1.x and SD 2.x at their published widths and canvases:
    SD 1.5 txt2img (DPM++ 2M) and img2img (Euler ancestral, strength
    0.75), the 9-channel SD 1.5 inpainting checkpoint (UniPC), and SD 2.1
    txt2img at 768^2 with v-prediction (DPM++ 2M), each through the worker
    with its launches counted (SD_UNET_LAUNCHES per UNet call)."""
    t0 = time.perf_counter()
    for model in (sd15, sd15_inpaint, sd21):
        registry.get_pipeline(model, allow_random_init=True)
    pipe21 = registry.get_pipeline(sd21)
    log(f"[sd] {sd15}, {sd15_inpaint} and {sd21} resident in {time.perf_counter() - t0:.1f}s "
        f"(seeded random weights, {pipe21.dtype}); "
        f"{torch.cuda.memory_allocated() / 2**30 if device == 'cuda' else 0:.1f} GiB allocated")
    check(pipe21.prediction_type == "v_prediction",
          f"{sd21}: prediction type {pipe21.prediction_type}, not v_prediction")
    common = {"negative_prompt": "blurry", "num_inference_steps": steps, "guidance_scale": 7.0,
              "content_type": "image/png"}
    at15 = {**common, "height": size15, "width": size15}
    jobs = [
        ("sd15_txt2img", "txt2img", {**at15, "id": "sd15-txt2img-0", "workflow": "txt2img",
                                     "model_name": sd15, "seed": 3000,
                                     "prompt": "a lighthouse on a cliff at dusk",
                                     "parameters": {"scheduler_type":
                                                    "DPMSolverMultistepScheduler"}}),
        ("sd15_img2img", "img2img", {**at15, "id": "sd15-img2img-0", "workflow": "img2img",
                                     "model_name": sd15, "seed": 3001, "strength": 0.75,
                                     "prompt": "a lighthouse on a cliff, repainted",
                                     "start_image_uri": "start",
                                     "parameters": {"scheduler_type":
                                                    "EulerAncestralDiscreteScheduler"}}),
        ("sd15_inpaint9", "inpaint9", {**at15, "id": "sd15-inpaint9-0", "workflow": "inpaint",
                                       "model_name": sd15_inpaint, "seed": 3002,
                                       "prompt": "a lighthouse on a cliff, repainted",
                                       "start_image_uri": "start", "mask_image_uri": "mask",
                                       "parameters": {"scheduler_type":
                                                      "UniPCMultistepScheduler"}}),
        ("sd21_txt2img", "txt2img", {**common, "height": size21, "width": size21,
                                     "id": "sd21-txt2img-0", "workflow": "txt2img",
                                     "model_name": sd21, "seed": 3003,
                                     "prompt": "a lighthouse on a cliff at dusk",
                                     "parameters": {"scheduler_type":
                                                    "DPMSolverMultistepScheduler"}}),
    ]
    return serve_counted(smi, registry, jobs, {m: SD_UNET_LAUNCHES for m in (sd15, sd15_inpaint,
                                                                             sd21)},
                         device, tag="sd", where="SD path")


# kernel launches of one SDXL refiner UNet call: 88 attention (22
# transformer layers: four in each of two down resnets and three up resnets
# at two levels, four in the mid block; one self- and one cross-attention
# each) and 56 GroupNorm (28 resnets of two, 11 transformers, the output)
REFINER_UNET_LAUNCHES = {"flash_attention": 88, "group_norm": 56}


def serve_edit_path(smi: str, xl_registry, sd_registry, xl_launches: dict,
                    device: str = "cuda", sd15_p2p: str = SD15_P2P, sdxl_p2p: str = SDXL_P2P,
                    base: str = SDXL, refiner: str = REFINER, size15: int = 512,
                    size_xl_p2p: int = 768, size_xl: int = SIZE,
                    steps: int = STEPS) -> tuple[dict, dict]:
    """Phase 5, pix2pix and the refiner chain, each through the worker with
    its launches counted: timbrooks/instruct-pix2pix at 512^2 (SD 1.5's
    launches per UNet call, on `sd_registry`) and
    diffusers/sdxl-instructpix2pix-768 at 768^2 (`xl_launches` per call),
    each from the fake hive's start image at strength 0.3 (image guidance
    1.5); then an SDXL base txt2img job at 1024^2 with the SDXL refiner
    chained (strength 0.3: 9 refiner UNet calls of REFINER_UNET_LAUNCHES
    after the base's 30), on `xl_registry` beside the base."""
    t0 = time.perf_counter()
    sd_registry.get_pipeline(sd15_p2p, allow_random_init=True)
    for model in (sdxl_p2p, refiner):
        xl_registry.get_pipeline(model, allow_random_init=True)
    log(f"[edit] {sd15_p2p}, {sdxl_p2p} and {refiner} resident in "
        f"{time.perf_counter() - t0:.1f}s (seeded random weights); "
        f"{torch.cuda.memory_allocated() / 2**30 if device == 'cuda' else 0:.1f} GiB allocated")
    common = {"negative_prompt": "blurry", "num_inference_steps": steps, "guidance_scale": 7.0,
              "content_type": "image/png"}
    edit = {**common, "workflow": "img2img", "strength": 0.3, "start_image_uri": "start",
            "prompt": "make it a snowy winter evening"}
    sd_jobs = [("sd15_pix2pix", "pix2pix",
                {**edit, "id": "sd15-pix2pix-0", "model_name": sd15_p2p, "seed": 5000,
                 "height": size15, "width": size15,
                 "parameters": {"scheduler_type": "EulerAncestralDiscreteScheduler"}})]
    xl_jobs = [("sdxl_pix2pix", "pix2pix",
                {**edit, "id": "sdxl-pix2pix-0", "model_name": sdxl_p2p, "seed": 5001,
                 "height": size_xl_p2p, "width": size_xl_p2p,
                 "parameters": {"scheduler_type": "DPMSolverMultistepScheduler",
                                "large_model": True}}),
               ("sdxl_refined", "txt2img",
                {**common, "id": "sdxl-refined-0", "workflow": "txt2img", "model_name": base,
                 "seed": 5002, "prompt": "a lighthouse on a cliff at dusk, refined",
                 "height": size_xl, "width": size_xl,
                 "parameters": {"scheduler_type": "DPMSolverMultistepScheduler",
                                "refiner": {"model_name": refiner}}})]
    paths, served = serve_counted(smi, sd_registry, sd_jobs, {sd15_p2p: SD_UNET_LAUNCHES},
                                  device, tag="edit", where="edit path")
    xl_paths, xl_served = serve_counted(smi, xl_registry, xl_jobs,
                                        {sdxl_p2p: xl_launches, base: xl_launches,
                                         refiner: REFINER_UNET_LAUNCHES},
                                        device, tag="edit", where="edit path")
    paths.update(xl_paths)
    served["jobs"].update(xl_served["jobs"])
    served["served_s"] += xl_served["served_s"]
    for job_id in ("sd15-pix2pix-0", "sdxl-pix2pix-0"):
        check(served["jobs"][job_id]["image_guidance_scale"] == 1.5,
              f"{job_id}: image guidance {served['jobs'][job_id]['image_guidance_scale']}, "
              "not strength 0.3 x 5")
    return paths, served


def pipeline_bytes(pipe) -> int:
    """Bytes of a pipeline's weights on its device."""
    return sum(t.numel() * t.element_size()
               for module in (pipe.unet, pipe.vae, *pipe.text_encoders)
               for t in module.state_dict().values())


def serve_checkpoint_path(smi: str, device: str = "cuda", model: str = SD15, size: int = 512,
                          steps: int = STEPS,
                          fillers=("test/tiny-sd", "test/tiny-xl", "test/tiny-inpaint",
                                   "test/tiny-pix2pix")) -> tuple[dict, dict]:
    """Phase 5, the checkpoint path: `model`'s seeded full-width weights
    written as fp16 safetensors in diffusers layout (SD 1.x's 1x1-conv
    `proj_in` / `proj_out`) under a temporary model root, then one txt2img
    job served through the worker's Registry over that root, which loads
    them (load time and bytes read printed; its launches counted). Its
    image must equal, bit for bit, the same job on a pipeline given the
    same fp16 tensors through `weights=`. Then an eviction on purpose: the
    registry fills with `fillers` until the fifth model evicts `model`,
    the least recently used, and the device's allocated memory must fall
    by that model's bytes (within 10%); a second job on `model` rebuilds it
    from the files and must give the first job's image bit for bit."""
    import gc
    import shutil
    import tempfile

    from chiaswarm_tpu_torch.job_arguments import format_args
    from chiaswarm_tpu_torch.pipelines.stable_diffusion import SDPipeline
    from chiaswarm_tpu_torch.registry import Registry
    from chiaswarm_tpu_torch.workflows.diffusion import diffusion_callback

    root = Path(tempfile.mkdtemp(prefix="chip-smoke-models-"))
    try:
        t0 = time.perf_counter()
        seeded = SDPipeline(model, device=device, allow_random_init=True)
        written = write_checkpoint(seeded, root / model, dtype=torch.float16)
        # the same fp16 tensors in the port's layout, for the pipeline given them
        given_weights = {name: {k: v.detach().to("cpu", torch.float16)
                                for k, v in module.state_dict().items()}
                         for name, module in (("unet", seeded.unet), ("vae", seeded.vae))}
        given_weights["text"] = [{k: v.detach().to("cpu", torch.float16)
                                  for k, v in e.state_dict().items()}
                                 for e in seeded.text_encoders]
        del seeded
        gc.collect()
        log(f"[checkpoint] {model}: seeded weights written as fp16 safetensors, {written} bytes, "
            f"in {time.perf_counter() - t0:.1f}s")
        registry = Registry(torch.device(device), str(root))
        pipe = registry.get_pipeline(model)
        check(pipe.weights_source == "checkpoint", f"{model}: weights {pipe.weights_source}")
        load = pipe.checkpoint
        model_bytes = pipeline_bytes(pipe)
        log(f"[checkpoint] {model} loaded from {load['dir']} by the worker's Registry: "
            f"{load['bytes']} bytes read in {load['load_s']:.2f}s "
            f"({load['bytes'] / max(load['load_s'], 1e-9) / 1e9:.2f} GB/s); {model_bytes} bytes "
            f"of {pipe.dtype} weights on the device")
        del pipe
        job = {"id": "sd15-checkpoint-0", "workflow": "txt2img", "model_name": model,
               "seed": 6000, "prompt": "a lighthouse on a cliff at dusk",
               "negative_prompt": "blurry", "height": size, "width": size,
               "num_inference_steps": steps, "guidance_scale": 7.0, "content_type": "image/png",
               "parameters": {"scheduler_type": "DPMSolverMultistepScheduler"}}
        jobs = [("sd15_checkpoint", "txt2img", job)]
        paths, served = serve_counted(smi, registry, jobs, {model: SD_UNET_LAUNCHES}, device,
                                      tag="checkpoint", where="checkpoint path")
        first = served["jobs"][job["id"]]
        check(first["weights"] == "checkpoint", f"{job['id']}: weights {first['weights']}")

        # the same job on a pipeline given the same fp16 tensors, through the
        # same callback
        given = SDPipeline(model, device=device, weights=given_weights)
        del given_weights
        _, args = format_args(dict(job))
        args.pop("id", None)
        name, seed = args.pop("model_name"), args.pop("seed")
        results, config = diffusion_callback("chip-smoke", name, registry=Resident({name: given}),
                                             seed=seed, **args)
        del given
        image = decode_artifact(results["primary"])
        check(config["weights"] == "given",
              f"the comparison pipeline's weights {config['weights']}")
        same = hashlib.sha256(image.tobytes()).hexdigest() == first["pixels_sha256"]
        log(f"[checkpoint] {job['id']} from the checkpoint against the same job on the same fp16 "
            f"tensors given through weights=: images equal bit for bit: {same}")
        check(same, f"{job['id']}: the checkpoint's image differs from the given weights' image")

        # an eviction on purpose: the fifth resident model evicts `model`
        for filler in fillers[:-1]:
            registry.get_pipeline(filler)
        check(registry.resident_models() == sorted([model, *fillers[:-1]]),
              f"resident before the eviction: {registry.resident_models()}")
        gc.collect()
        on_card = torch.device(device).type == "cuda"
        before = torch.cuda.memory_allocated() if on_card else 0
        fifth = registry.get_pipeline(fillers[-1])
        gc.collect()
        after = torch.cuda.memory_allocated() if on_card else 0
        check(model not in registry.resident_models(),
              f"{model} still resident after a fifth model: {registry.resident_models()}")
        expected = model_bytes - pipeline_bytes(fifth)
        del fifth
        eviction = {"resident_after": registry.resident_models(), "model_bytes": model_bytes,
                    "allocated_before": before, "allocated_after": after,
                    "fall": before - after, "expected_fall": expected}
        log(f"[checkpoint] {fillers[-1]}, the fifth resident model, evicted {model}: allocated "
            f"{before} -> {after} bytes, a fall of {before - after} against the {expected} "
            f"bytes that {model} held beyond {fillers[-1]}; resident {registry.resident_models()}")
        if on_card:
            check(abs((before - after) - expected) <= 0.1 * model_bytes,
                  f"allocated memory fell by {before - after} bytes, not about {expected}")

        # a later job on the evicted name rebuilds it from the files
        again = dict(job, id="sd15-checkpoint-1")
        rebuilt_paths, rebuilt = serve_counted(smi, registry, [("sd15_rebuilt", "txt2img", again)],
                                               {model: SD_UNET_LAUNCHES}, device,
                                               tag="checkpoint", where="checkpoint path")
        second = rebuilt["jobs"][again["id"]]
        check(model in registry.resident_models() and second["weights"] == "checkpoint",
              f"{model} was not rebuilt from its checkpoint")
        check(second["pixels_sha256"] == first["pixels_sha256"],
              f"{again['id']}: the rebuilt pipeline's image differs from the first")
        log(f"[checkpoint] {again['id']}: {model} rebuilt from its checkpoint; the image equals "
            "the first job's bit for bit")
        paths.update(rebuilt_paths)
        served["jobs"].update(rebuilt["jobs"])
        served.update(written=written, load=load, eviction=eviction)
        return paths, served
    finally:
        shutil.rmtree(root, ignore_errors=True)


# the adapters of phase 5's adapter path. SDXL: kohya layout, rank 32 and
# alpha 16 over the 722 Linear modules of LORA_UNET_SUFFIXES (70
# transformer blocks x 10, and the 11 transformer models' proj_in /
# proj_out), rank 8 over both text encoders' attention and MLP (264). SD
# 1.5: PEFT layout, rank 64 over its 160 block modules, its 32 proj_in /
# proj_out written as 1x1 convs (skipped), as a few-step distillation LoRA
# is served: LCMScheduler at 4 steps.
ADAPTER_SDXL = dict(layout="kohya", rank=32, alpha=16.0, te_rank=8, seed=21)
ADAPTER_SD15 = dict(layout="peft", rank=64, conv_proj=True, seed=22)
ADAPTER_SCALE = 0.8


def serve_adapter_path(smi: str, xl_launches: dict, device: str = "cuda", sdxl: str = SDXL,
                       sd15: str = SD15, size_xl: int = SIZE, size15: int = 512,
                       steps: int = STEPS, lcm_steps: int = 4,
                       fillers=("test/tiny-sd", "test/tiny-xl", "test/tiny-inpaint")
                       ) -> tuple[dict, dict]:
    """Phase 5, the adapter path: a registry of its own over a temporary
    root holds SDXL and SD 1.5 on seeded random weights, and every adapter
    is written there from seeded tensors (ADAPTER_SDXL, ADAPTER_SD15, a
    dual-encoder and a diffusers textual inversion, a custom VAE of each
    VAE config). Their load times (factors cold from the file and warm from
    the cache, the device stacks, the tables, the VAEs) and bytes are
    printed. Then, through the worker, each counted as the other paths
    are: SDXL 1024^2 txt2img plain, with the LoRA at ADAPTER_SCALE, with it
    at scale 0, plain again, and with the textual inversion and the custom
    VAE; SD 1.5 512^2 30-step DPM++ 2M plain (first, so that it and not an
    adapter job takes the new pipeline's first-call costs), LCM at
    `lcm_steps` plain and with its LoRA, and 30-step with its textual
    inversion and custom VAE. Checks:
    every adapter job launches what its plain twin does; scale 0 and the
    plain job after the LoRA job give the plain job's image bit for bit;
    the LoRA changes it. Then one bf16 SDXL UNet call with the delta,
    through the kernels, against f32 on the plain path (phase 7's bound),
    the delta's device time by the profiler (SDXL and SD 1.5 UNet calls),
    and an eviction: `fillers` push SDXL out, and its adapter stacks,
    table and VAE leave the device with it."""
    import gc
    import shutil
    import tempfile

    from chiaswarm_tpu_torch.device import synchronize
    from chiaswarm_tpu_torch.loras import resolve_lora
    from chiaswarm_tpu_torch.models.lora import factors_nbytes, match_factors
    from chiaswarm_tpu_torch.registry import Registry

    on_card = torch.device(device).type == "cuda"

    def allocated():
        gc.collect()
        return torch.cuda.memory_allocated() if on_card else 0

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        synchronize(torch.device(device))
        return out, time.perf_counter() - t0

    root = Path(tempfile.mkdtemp(prefix="chip-smoke-adapters-"))
    loras = root / "loras"
    try:
        registry = Registry(torch.device(device), str(root), str(loras))
        pipes = {m: registry.get_pipeline(m, allow_random_init=True) for m in (sdxl, sd15)}
        files = {
            "sdxl_lora": write_lora(loras / "sdxl-kohya.safetensors", pipes[sdxl],
                                    **ADAPTER_SDXL),
            "sd15_lora": write_lora(loras / "sd15-peft-lcm.safetensors", pipes[sd15],
                                    **ADAPTER_SD15),
            "sdxl_ti": write_ti(loras / "sdxl-dual.safetensors", pipes[sdxl], "dual", seed=23),
            "sd15_ti": write_ti(loras / "sd15-ti.safetensors", pipes[sd15], "diffusers",
                                seed=24),
            "sdxl_vae": write_vae(root / "smoke/sdxl-vae", pipes[sdxl], 25, "vae"),
            "sd15_vae": write_vae(root / "smoke/sd-vae-ft", pipes[sd15], 26),
        }
        log(f"[adapter] files written under a temporary root: {json.dumps(files)}")
        loads = {}
        for model, key, ti, vae in ((sdxl, "sdxl", "sdxl-dual.safetensors", "smoke/sdxl-vae"),
                                    (sd15, "sd15", "sd15-ti.safetensors", "smoke/sd-vae-ft")):
            pipe = pipes[model]
            lora = resolve_lora(files[f"{key}_lora"]["name"], str(loras))
            (factors, hit_cold), cold_s = timed(
                lambda: registry.lora_cache.resolve(lora, model, str(root)))
            (_, hit_warm), warm_s = timed(
                lambda: registry.lora_cache.resolve(lora, model, str(root)))
            (_, stats), stacks_s = timed(lambda: pipe.adapter_stacks(lora))
            (extras, _), ti_s = timed(lambda: pipe.ti_apply(ti))
            custom, vae_s = timed(lambda: pipe.custom_vae(vae))
            check(not hit_cold and hit_warm, f"{model}: factor cache hits {hit_cold}, {hit_warm}")
            written = files[f"{key}_lora"]
            check(stats["matched"] == written["modules"] - written["conv"]
                  and stats["unmatched"] == written["conv"],
                  f"{model}: adapter modules {stats}, written {written}")
            loads[key] = {
                "lora_cold_s": cold_s, "lora_warm_s": warm_s, "stacks_s": stacks_s,
                "host_bytes": factors_nbytes(factors), "device_bytes": stats["bytes"],
                "matched": stats["matched"], "unmatched": stats["unmatched"],
                "ti_s": ti_s, "ti_bytes": sum(e.numel() * e.element_size()
                                              for e in extras if e is not None),
                "vae_s": vae_s, "vae_bytes": sum(t.numel() * t.element_size()
                                                 for t in custom.state_dict().values())}
            del factors, extras, custom
            row = loads[key]
            log(f"[adapter] {model} on {smi}: LoRA factors {row['host_bytes']} bytes on the host, "
                f"read cold from the file in {cold_s:.3f}s, warm from the cache in "
                f"{warm_s * 1e3:.3f} ms; {row['matched']} modules matched, {row['unmatched']} "
                f"skipped; device stacks {row['device_bytes']} bytes built in {stacks_s:.3f}s; "
                f"textual inversion {row['ti_bytes']} bytes in {ti_s * 1e3:.1f} ms; custom VAE "
                f"{row['vae_bytes']} bytes in {vae_s:.3f}s")

        prompt = "a lighthouse on a cliff at dusk"
        xl = {"workflow": "txt2img", "model_name": sdxl, "negative_prompt": "blurry",
              "height": size_xl, "width": size_xl, "num_inference_steps": steps,
              "guidance_scale": 7.0, "content_type": "image/png", "seed": 7000,
              "prompt": prompt}
        dpm = {"scheduler_type": "DPMSolverMultistepScheduler"}
        lora_xl = {"lora": "sdxl-kohya.safetensors"}
        ti_xl = {"textual_inversion": "sdxl-dual.safetensors", "vae": "smoke/sdxl-vae"}
        sd = {**xl, "model_name": sd15, "height": size15, "width": size15, "seed": 7100}
        lcm = {"scheduler_type": "LCMScheduler"}
        jobs = [
            ("sdxl_plain", {**xl, "id": "adapter-sdxl-plain-0", "parameters": dpm}),
            ("sdxl_lora", {**xl, **lora_xl, "id": "adapter-sdxl-lora-0",
                           "parameters": {**dpm, "lora_scale": ADAPTER_SCALE}}),
            ("sdxl_lora_scale0", {**xl, **lora_xl, "id": "adapter-sdxl-lora-scale0-0",
                                  "parameters": {**dpm, "lora_scale": 0.0}}),
            ("sdxl_plain_after", {**xl, "id": "adapter-sdxl-plain-1", "parameters": dpm}),
            ("sdxl_ti_plain", {**xl, "id": "adapter-sdxl-ti-plain-0", "seed": 7001,
                               "prompt": f"{prompt}, <sdxl-dual>", "parameters": dpm}),
            ("sdxl_ti_vae", {**xl, "id": "adapter-sdxl-ti-vae-0", "seed": 7001,
                             "prompt": f"{prompt}, <sdxl-dual>", "parameters": {**dpm, **ti_xl}}),
            ("sd15_ti_plain", {**sd, "id": "adapter-sd15-ti-plain-0", "seed": 7101,
                               "prompt": f"{prompt}, <smoke-style>", "parameters": dpm}),
            ("sd15_lcm_plain", {**sd, "id": "adapter-sd15-lcm-plain-0",
                                "num_inference_steps": lcm_steps, "guidance_scale": 1.5,
                                "parameters": lcm}),
            ("sd15_lcm_lora", {**sd, "id": "adapter-sd15-lcm-lora-0",
                               "num_inference_steps": lcm_steps, "guidance_scale": 1.5,
                               "lora": "sd15-peft-lcm.safetensors", "parameters": lcm}),
            ("sd15_ti_vae", {**sd, "id": "adapter-sd15-ti-vae-0", "seed": 7101,
                             "prompt": f"{prompt}, <smoke-style>",
                             "parameters": {**dpm, "textual_inversion": "sd15-ti.safetensors",
                                            "vae": "smoke/sd-vae-ft"}}),
        ]
        paths, served = serve_counted(
            smi, registry, [(kind, "txt2img", job) for kind, job in jobs],
            {sdxl: xl_launches, sd15: SD_UNET_LAUNCHES}, device, tag="adapter",
            where="adapter path", hold=False)
        got = {kind: served["jobs"][job["id"]] for kind, job in jobs}
        for kind, twin in (("sdxl_lora", "sdxl_plain"), ("sdxl_lora_scale0", "sdxl_plain"),
                           ("sdxl_ti_vae", "sdxl_ti_plain"), ("sd15_lcm_lora", "sd15_lcm_plain"),
                           ("sd15_ti_vae", "sd15_ti_plain")):
            job, plain = got[kind], got[twin]
            check(job["launches"] == plain["launches"],
                  f"{kind}: launches {job['launches']}, its plain twin's {plain['launches']}")
            adapter = job["adapter"]
            if "lora" in dict(jobs)[kind]:
                check(adapter.get("lora_mode") == "delta", f"{kind}: {adapter}")
            log(f"[adapter] {kind}: UNet step {job['timings']['unet_step_ms']:.1f} ms against "
                f"{plain['timings']['unet_step_ms']:.1f} ms plain ({twin}); job "
                f"{job['timings']['job_s']:.3f}s against {plain['timings']['job_s']:.3f}s; "
                f"adapters resolved in {job['timings'].get('adapters_s', 0.0) * 1e3:.1f} ms; "
                f"{json.dumps(adapter)}")
        same = {kind: got[kind]["pixels_sha256"] == got["sdxl_plain"]["pixels_sha256"]
                for kind in ("sdxl_lora", "sdxl_lora_scale0", "sdxl_plain_after")}
        log(f"[adapter] SDXL images equal to the plain job's bit for bit: {json.dumps(same)}")
        check(same["sdxl_lora_scale0"], "the job at lora_scale 0 differs from the plain job")
        check(same["sdxl_plain_after"], "the plain job after the LoRA job differs from before it")
        check(not same["sdxl_lora"], "the LoRA left the SDXL image unchanged")
        hold_launches(served, "adapter path")

        # the delta's numerics and device time, at the served scale
        e2e, profile = {}, {}
        for model, lora_name, size in ((sdxl, "sdxl-kohya.safetensors", size_xl),
                                       (sd15, "sd15-peft-lcm.safetensors", size15)):
            pipe = pipes[model]
            factors, _ = registry.lora_cache.resolve(resolve_lora(lora_name, str(loras)),
                                                     model, str(root))
            matched = match_factors(factors, pipe.unet_index)[0]
            if model == sdxl:
                e2e[model] = end_to_end_bf16_check(pipe, size, ("unet",), 2,
                                                   adapter=(matched, ADAPTER_SCALE))
            profile[model] = {
                "plain": profile_main_path(pipe, size, parts=("unet",))["unet"],
                "lora": profile_main_path(pipe, size, parts=("unet",),
                                          adapter=(matched, ADAPTER_SCALE))["unet"]}
            del factors, matched
            plain, with_delta = profile[model]["plain"], profile[model]["lora"]
            delta_ms, delta_n = with_delta["categories_ms_launches"][LORA_CATEGORY]
            device, device_plain = with_delta["device_ms_per_call"], plain["device_ms_per_call"]
            log(f"[adapter] {model} UNet call with its LoRA on {smi}: device {device:.2f} ms "
                f"against {device_plain:.2f} plain (difference {device - device_plain:.2f}); "
                f"the delta's own category {delta_ms:.3f} ms in {delta_n:g} launches; wall "
                f"{with_delta['unprofiled_wall_ms_per_call']:.2f} ms against "
                f"{plain['unprofiled_wall_ms_per_call']:.2f} unprofiled")
            log_profile({"unet": with_delta}, smi)
            for kernel, (ms, n) in sorted(with_delta["lora_delta_kernels"].items(),
                                          key=lambda kv: -kv[1][0]):
                log(f"[adapter]   delta kernel {ms:.3f} ms, {n:g} launches: {kernel[:100]}")

        # an eviction on purpose: SDXL leaves with its adapter state
        adapter_bytes = (loads["sdxl"]["device_bytes"] + loads["sdxl"]["ti_bytes"]
                         + loads["sdxl"]["vae_bytes"])
        model_bytes = pipeline_bytes(pipes[sdxl])
        del pipes
        registry.get_pipeline(sd15)
        for filler in fillers[:-1]:
            registry.get_pipeline(filler)
        operands_before = registry.lora_cache.operands.resident_bytes
        before = allocated()
        fifth = registry.get_pipeline(fillers[-1])
        after = allocated()
        check(sdxl not in registry.resident_models(),
              f"{sdxl} still resident: {registry.resident_models()}")
        operands_freed = operands_before - registry.lora_cache.operands.resident_bytes
        expected = model_bytes + adapter_bytes - pipeline_bytes(fifth)
        del fifth
        eviction = {"model_bytes": model_bytes, "adapter_bytes": adapter_bytes,
                    "operand_bytes_freed": operands_freed, "allocated_before": before,
                    "allocated_after": after, "fall": before - after, "expected_fall": expected}
        log(f"[adapter] {fillers[-1]} evicted {sdxl}: the adapter cache freed {operands_freed} "
            f"bytes of device stacks (built {loads['sdxl']['device_bytes']}); allocated {before} "
            f"-> {after}, a fall of {before - after} against {expected} expected ({model_bytes} "
            f"of weights and {adapter_bytes} of adapter stacks, table and VAE, less "
            f"{fillers[-1]}'s)")
        check(operands_freed == loads["sdxl"]["device_bytes"],
              f"the eviction freed {operands_freed} bytes of adapter stacks, not "
              f"{loads['sdxl']['device_bytes']}")
        if on_card:
            check(expected - adapter_bytes / 4 <= before - after <= expected + 0.02 * model_bytes,
                  f"allocated memory fell by {before - after} bytes, not about {expected}")
        served.update(loads=loads, e2e=e2e, profile=profile, eviction=eviction, files=files)
        return paths, served
    finally:
        shutil.rmtree(root, ignore_errors=True)


# --- phase 5, the batched path ---

# the prompts of the batched path's jobs
BATCH_PROMPTS = ("a lighthouse on a cliff at dusk", "a red fox in fresh snow",
                 "a sailing ship in a storm", "a glass greenhouse full of ferns",
                 "a steam train crossing a bridge", "an old library with tall windows",
                 "a hot air balloon over a valley", "a koi pond in autumn")
# the SDXL LoRAs of the per-row pass: kohya rank 16 (alpha 8) and PEFT rank
# 8 over LORA_UNET_SUFFIXES, the UNet alone
BATCH_ADAPTERS = {"a": dict(layout="kohya", rank=16, alpha=8.0, seed=31),
                  "b": dict(layout="peft", rank=8, seed=32)}


def _grid(n: int, size: int) -> tuple:
    """The shape of the artifact of a job of n images at size^2."""
    from chiaswarm_tpu_torch.post_processors.output_processor import GRID_LAYOUTS

    rows, cols = next(layout for cap, layout in GRID_LAYOUTS if n <= cap)
    return (rows * size, cols * size, 3)


def serve_group(registry, jobs: list, device: str = "cuda", max_coalesce: int = 8,
                files: dict | None = None, settings_kw: dict | None = None,
                polls: list | None = None) -> tuple[dict, dict, float]:
    """Every job of `jobs` queued before the worker's first poll, served
    through the worker (`max_coalesce` 1 serves each alone) with the
    kernels' launches counted; a `start_image_uri`, a ControlNet's
    `control_image_uri` or a stitch job's `resultUri` naming a key of
    `files` {name: bytes} is served by the fake hive; `settings_kw`
    overrides the worker's settings (as serve_counted's); `polls`, where
    given, receives the worker's polls -> (envelopes by id, {kernel:
    (launches, {shape: launches})}, wall seconds)."""
    from chiaswarm_tpu_torch.fake_hive import FakeHive
    from chiaswarm_tpu_torch.ops.flash_attention import COUNTER as FA_COUNTER
    from chiaswarm_tpu_torch.ops.group_norm import COUNTER as GN_COUNTER
    from chiaswarm_tpu_torch.settings import Settings
    from chiaswarm_tpu_torch.worker import Worker

    hive = FakeHive(token="smoke-token")
    try:
        uris = {name: hive.enqueue_file(name, data, "image/jpeg")
                for name, data in (files or {}).items()}
        jobs = [dict(job, **({"start_image_uri": uris[job["start_image_uri"]]}
                             if "start_image_uri" in job else {})) for job in jobs]
        for job in jobs:
            cn = job.get("parameters", {}).get("controlnet")
            if cn and cn.get("control_image_uri") in uris:
                job["parameters"] = {**job["parameters"], "controlnet": {
                    **cn, "control_image_uri": uris[cn["control_image_uri"]]}}
            if job.get("workflow") == "stitch":
                job["jobs"] = [dict(j, resultUri=uris.get(j["resultUri"], j["resultUri"]))
                               for j in job["jobs"]]
        settings = Settings(**{"sdaas_token": "smoke-token", "sdaas_uri": hive.uri,
                               "worker_name": "chip-smoke",
                               "model_root_dir": registry.model_root_dir,
                               "lora_root_dir": registry.lora_root_dir or Settings.lora_root_dir,
                               "max_coalesce": max_coalesce, **(settings_kw or {})})
        worker = Worker(settings=settings, device=device, registry=registry, poll_seconds=0.05,
                        heartbeat_seconds=HEARTBEAT_SECONDS)
        hive.enqueue(*jobs)
        FA_COUNTER.reset()
        GN_COUNTER.reset()
        t0 = time.perf_counter()
        asyncio.run(worker.run(max_jobs=len(jobs)))
        wall = time.perf_counter() - t0
        launches = {"flash_attention": (FA_COUNTER.launches, Counter(FA_COUNTER.shapes)),
                    "group_norm": (GN_COUNTER.launches, Counter(GN_COUNTER.shapes))}
        fma = {k: n for k, n in FA_COUNTER.routes.items()
               if k[0] == "fma" and k[1] == torch.bfloat16}
        results = hive.wait_for_results(len(jobs), timeout=30)
        check(hive.auth_failures == 0, "the hive refused the worker's bearer token")
        if polls is not None:
            polls.extend(hive.polls)
    finally:
        hive.close()
    check(not fma, f"bf16 attention took the FMA kernel on the batched path: {fma}")
    return {r["id"]: r for r in results}, launches, wall


def check_group(name: str, jobs: list, results: dict, launches: dict, wall: float,
                per_call: dict, size: int, coalesced: bool, hold: bool = True) -> dict:
    """Every envelope of a served group (sha256, a decodable image of the
    job's grid that is not constant, finite latents; for a coalesced pass
    `batched_with`, `batch_rows` and `padded_rows`), and its launches held
    to the prediction: a pass launches UNet calls x `per_call` plus one VAE
    encode per request with a start image and one decode per image at
    768^2 and up (one for the pass below); alone, each job its own UNet
    calls, encode and one decode (with `hold` false the launches are only
    printed: a CPU rehearsal launches no kernel). -> {"row", "images" and
    "configs" by id}."""
    import numpy as np

    from chiaswarm_tpu_torch.pipelines.common import pad_bucket

    counts = [j.get("parameters", {}).get("num_images_per_prompt", 1) for j in jobs]
    total = sum(counts)
    images, configs, offset = {}, {}, 0
    for job, n in zip(jobs, counts):
        r = results[job["id"]]
        cfg = r["pipeline_config"]
        check(not r.get("fatal_error") and "error" not in cfg, f"{job['id']}: {cfg}")
        image = decode_artifact(r["artifacts"]["primary"])
        check(image.shape == _grid(n, size), f"{job['id']}: image {image.shape}")
        check(int(image.max()) != int(image.min()), f"{job['id']}: constant image")
        check(cfg["latents"]["finite"], f"{job['id']}: non-finite latents")
        if coalesced:
            check(cfg.get("batched_with") == len(jobs) and cfg["batch_rows"] == [offset, n]
                  and cfg["padded_rows"] == pad_bucket(total),
                  f"{job['id']}: batched_with {cfg.get('batched_with')}, batch_rows "
                  f"{cfg.get('batch_rows')}, padded_rows {cfg.get('padded_rows')}")
        else:
            check("batched_with" not in cfg, f"{job['id']} alone: {cfg.get('batched_with')}")
        images[job["id"]], configs[job["id"]] = image, cfg
        offset += n
    cfg = configs[jobs[0]["id"]]
    unet_calls = cfg["steps"] - cfg.get("t_start", 0)
    encodes = sum("start_image_uri" in j for j in jobs)
    if coalesced:
        decodes = total if size >= 768 else 1
        predicted = {k: unet_calls * per_call[k] + encodes * ENCODE_LAUNCHES[k]
                     + decodes * DECODE_LAUNCHES[k] for k in per_call}
        job_s = cfg["timings"]["job_s"]
        step_ms = cfg["timings"]["unet_step_ms"]
    else:
        predicted = {k: len(jobs) * (unet_calls * per_call[k] + DECODE_LAUNCHES[k])
                     + encodes * ENCODE_LAUNCHES[k] for k in per_call}
        job_s = sum(c["timings"]["job_s"] for c in configs.values())
        step_ms = float(np.mean([c["timings"]["unet_step_ms"] for c in configs.values()]))
    counted = {k: v[0] for k, v in launches.items()}
    check(counted == predicted or not hold,
          f"{name}: launches {counted} != predicted {predicted}")
    if counted != predicted:
        log(f"[batched] {name}: launches {counted}, predicted {predicted} (not held)")
    row = {"jobs": len(jobs), "images": total, "wall_s": wall, "job_s": job_s,
           "images_per_s": total / job_s, "unet_step_ms": step_ms, "launches": counted,
           "text_encode_s": cfg["timings"]["text_encode_s"],
           "embed_cache": cfg.get("embed_cache")}
    log(f"[batched] {name} ({'one pass' if coalesced else 'each job alone'}): {len(jobs)} jobs, "
        f"{total} images at {size}^2" + (f", {pad_bucket(total)} padded rows" if coalesced
                                         else "")
        + f"; {job_s:.3f}s of jobs ({wall:.3f}s served), {row['images_per_s']:.3f} images/s; "
        f"UNet step {step_ms:.1f} ms; text_encode {row['text_encode_s']:.4f}s; embed cache "
        f"{row['embed_cache']}; launches {json.dumps(counted)} ({unet_calls} UNet calls x "
        f"{json.dumps(per_call)}, {encodes} encodes, {decodes if coalesced else len(jobs)} "
        "decodes)")
    return {"row": row, "images": images, "configs": configs}


def serve_batched_path(smi: str, xl_launches: dict, device: str = "cuda", sdxl: str = SDXL,
                       sd15: str = SD15, size_xl: int = SIZE, size15: int = 512,
                       steps: int = BATCHED_STEPS, big_jobs: int = 8, big_images: int = 8,
                       hold: bool = True) -> tuple[dict, dict]:
    """Phase 5, the batched path: coalesced groups served through the fake
    hive and the worker (every job queued before the first poll), in
    registries of their own on seeded random weights, `steps` steps, DPM++ 2M
    unless named, each group checked (`check_group`) and then served again
    with each job alone, for the images per second and step time of both.
    SDXL 1024^2: four txt2img jobs (one pass of 4 rows); three with counts
    (1, 2, 2) (5 rows padded to 8); the four again (the embedding cache
    serves every text row: text_encode_s falls, the images equal the
    first pass's bit for bit); the first of them with three other
    batchmates at the same padded size (its image bit for bit again); three
    img2img jobs at an explicit 1024^2 canvas from two distinct start images
    (strength 0.75, Euler ancestral); four jobs with per-row LoRAs (plain,
    LoRA a at 0.8, a at 0.5 by cross_attention_kwargs.scale, b at 1.0:
    `lora_mode` "delta" on the adapter rows, the plain row equal bit for bit
    to the same job in an all-plain pass of the same padded size, each
    adapter row moved), with the delta's launches and device time per UNet
    call by the profiler. The one job served alone against its coalesced
    self: step time and image difference in levels (other GEMM shapes and
    GroupNorm plans apply). SD 1.5 512^2: eight txt2img jobs (8 rows), then
    `big_jobs` jobs of `big_images` images, the largest pass the capacity
    admits (GroupNorm at 128 batch rows). `hold` false only prints the
    launches (the CPU rehearsal). -> ({kind: (jobs, launches)} of the
    coalesced passes, served)."""
    import gc
    import shutil
    import tempfile

    import numpy as np

    from chiaswarm_tpu_torch.capacity import coalesce_rows_limit
    from chiaswarm_tpu_torch.loras import resolve_lora
    from chiaswarm_tpu_torch.pipelines import lora_runtime
    from chiaswarm_tpu_torch.registry import Registry

    root = Path(tempfile.mkdtemp(prefix="chip-smoke-batched-path-"))
    loras = root / "loras"
    paths, served = {}, {}
    try:
        registry = Registry(torch.device(device), str(ROOT / ".no-models"), str(loras))
        t0 = time.perf_counter()
        pipe = registry.get_pipeline(sdxl, allow_random_init=True)
        log(f"[batched] {sdxl} resident in a registry of its own in "
            f"{time.perf_counter() - t0:.1f}s; a group holds at most "
            f"{coalesce_rows_limit(device, sdxl, size_xl)} images at {size_xl}^2")
        for key, spec in BATCH_ADAPTERS.items():
            write_lora(loras / f"xl-{key}.safetensors", pipe, **spec)
        xl = {"workflow": "txt2img", "model_name": sdxl, "negative_prompt": "blurry",
              "height": size_xl, "width": size_xl, "num_inference_steps": steps,
              "guidance_scale": 7.0, "content_type": "image/png",
              "parameters": {"scheduler_type": "DPMSolverMultistepScheduler"}}

        def txt(tag, i, **kw):
            return dict(xl, id=f"{tag}-{i}", prompt=BATCH_PROMPTS[i % len(BATCH_PROMPTS)],
                        seed=8000 + i, **kw)

        def both(name, jobs, per_call, size, files=None, alone_as=None):
            """Serve `jobs` as one pass, then each alone; a pass whose jobs
            have the shapes of an earlier pass's (`alone_as`) is set beside
            that pass's jobs served alone instead."""
            results, launches, wall = serve_group(registry, jobs, device, files=files)
            got = check_group(name, jobs, results, launches, wall, per_call, size, True, hold)
            served[name] = {"pass": got["row"]}
            paths[f"batched_{name}"] = (len(jobs), launches)
            if alone_as is None:
                solo_jobs = [dict(j, id=f"{j['id']}-alone") for j in jobs]
                results, launches, wall = serve_group(registry, solo_jobs, device,
                                                      max_coalesce=1, files=files)
                got["alone"] = check_group(f"{name} alone", solo_jobs, results, launches,
                                           wall, per_call, size, False, hold)
                served[name]["alone"] = got["alone"]["row"]
            solo = served[alone_as or name]["alone"]
            log(f"[batched] {name} on {smi}: {got['row']['images_per_s']:.3f} images/s "
                f"coalesced against {solo['images_per_s']:.3f} alone"
                + (f" ({alone_as}'s jobs)" if alone_as else "")
                + f" ({got['row']['images_per_s'] / solo['images_per_s']:.2f}x); UNet step "
                f"{got['row']['unet_step_ms']:.1f} ms for the pass against "
                f"{solo['unet_step_ms']:.1f} ms a job alone")
            return got

        first = both("sdxl_4", [txt("xl4", i) for i in range(4)], xl_launches, size_xl)
        counts = (1, 2, 2)
        both("sdxl_5_of_8", [txt("xl5", 4 + i, parameters={
            **xl["parameters"], "num_images_per_prompt": n}) for i, n in enumerate(counts)],
            xl_launches, size_xl)
        # one job alone against its coalesced self
        job_id = "xl4-0"
        alone = first["alone"]
        diff = (first["images"][job_id].astype(np.int16)
                - alone["images"][f"{job_id}-alone"].astype(np.int16))
        solo_vs = {"max_levels": int(np.abs(diff).max()),
                   "mean_levels": float(np.abs(diff).mean()),
                   "step_ms_coalesced": first["configs"][job_id]["timings"]["unet_step_ms"],
                   "step_ms_alone": alone["configs"][f"{job_id}-alone"]["timings"][
                       "unet_step_ms"]}
        served["solo_vs_coalesced"] = solo_vs
        log(f"[batched] {job_id} alone against its 4-row pass: UNet step "
            f"{solo_vs['step_ms_alone']:.1f} ms (2 CFG rows) against "
            f"{solo_vs['step_ms_coalesced']:.1f} ms (8 CFG rows, 4 images); images differ by "
            f"{solo_vs['max_levels']} levels at most, {solo_vs['mean_levels']:.3f} on average "
            "(other GEMM shapes and GroupNorm plans apply)")

        # the embedding cache: the same prompts and seeds again
        again = both("sdxl_4_cached", [txt("xl4", i) for i in range(4)], xl_launches, size_xl,
                     alone_as="sdxl_4")
        hits = [again["configs"][f"xl4-{i}"]["embed_cache"] for i in range(4)]
        equal = all(np.array_equal(again["images"][f"xl4-{i}"], first["images"][f"xl4-{i}"])
                    for i in range(4))
        log(f"[batched] the repeat pass: embed cache {hits[0]} (first pass "
            f"{first['configs']['xl4-0'].get('embed_cache')}), text_encode "
            f"{served['sdxl_4_cached']['pass']['text_encode_s']:.4f}s against "
            f"{served['sdxl_4']['pass']['text_encode_s']:.4f}s; images equal bit for bit: {equal}")
        check(hits[0] == {"hits": 8, "misses": 0}, f"the repeat pass's embed cache: {hits[0]}")
        check(served["sdxl_4_cached"]["pass"]["text_encode_s"]
              < served["sdxl_4"]["pass"]["text_encode_s"], "text_encode_s did not fall")
        check(equal, "the repeat pass's images differ from the first pass's")
        # one job, other batchmates, the same padded rows
        mates = both("sdxl_4_other_batchmates", [txt("xl4", 0)] + [
            txt("xl4b", 8 + i) for i in range(3)], xl_launches, size_xl, alone_as="sdxl_4")
        same = np.array_equal(mates["images"][job_id], again["images"][job_id])
        log(f"[batched] {job_id} with other batchmates at 4 padded rows: its image equals the "
            f"earlier pass's bit for bit: {same}")
        check(same, f"{job_id}: its image moved with its batchmates")

        # img2img: two distinct start images, three jobs
        files = {"start-a.jpg": image_bytes(start_image(size_xl), "JPEG"),
                 "start-b.jpg": image_bytes(start_image(size_xl).rotate(90), "JPEG")}
        i2i = dict(xl, workflow="img2img", strength=0.75,
                   parameters={"scheduler_type": "EulerAncestralDiscreteScheduler"})
        both("sdxl_img2img", [dict(i2i, id=f"xl-i2i-{i}", prompt=BATCH_PROMPTS[i], seed=8100 + i,
                                   start_image_uri=name)
                              for i, name in enumerate(("start-a.jpg", "start-b.jpg",
                                                        "start-a.jpg"))],
             xl_launches, size_xl, files=files)

        # per-row LoRA: plain, a at 0.8, a at 0.5, b at 1.0
        lora_jobs = [txt("xl-lora", 0), txt("xl-lora", 1, lora="xl-a.safetensors",
                                            lora_scale=0.8),
                     txt("xl-lora", 2, lora="xl-a.safetensors",
                         parameters={**xl["parameters"],
                                     "cross_attention_kwargs": {"scale": 0.5}}),
                     txt("xl-lora", 3, lora="xl-b.safetensors")]
        with_lora = both("sdxl_lora", lora_jobs, xl_launches, size_xl)
        plain = both("sdxl_lora_plain", [{k: v for k, v in j.items()
                                          if k not in ("lora", "lora_scale")}
                                         | {"id": j["id"] + "-plain",
                                            "parameters": xl["parameters"]}
                                         for j in lora_jobs], xl_launches, size_xl,
                     alone_as="sdxl_4")
        modes = [with_lora["configs"][j["id"]].get("lora_mode") for j in lora_jobs]
        scales = [with_lora["configs"][j["id"]].get("lora_scale") for j in lora_jobs]
        moved = [int(np.abs(with_lora["images"][j["id"]].astype(np.int16)
                            - plain["images"][j["id"] + "-plain"].astype(np.int16)).max())
                 for j in lora_jobs]
        log(f"[batched] per-row LoRA pass: modes {modes}, scales {scales}; each row against the "
            f"same job in an all-plain pass of 4 padded rows: {moved} levels at most")
        check(modes == [None, "delta", "delta", "delta"], f"lora modes {modes}")
        check(scales == [None, 0.8, 0.5, 1.0], f"lora scales {scales}")
        check(moved[0] == 0, f"the plain row moved by {moved[0]} beside the adapters")
        check(min(moved[1:]) > 2, f"an adapter left its row unchanged: {moved}")
        # the delta's launches and device time in one UNet call at 8 CFG rows
        refs = [resolve_lora(f"xl-{key}.safetensors", str(loras)) for key in BATCH_ADAPTERS]
        stacks = [pipe.adapter_stacks(ref)[0] for ref in refs]
        gains = torch.tensor([[0.0, 0.8, 0.5, 0.0], [0.0, 0.0, 0.0, 1.0]]).repeat(1, 2)
        x, t, ctx, added = unet_inputs(pipe, size_xl, rows=8)
        with lora_runtime.applied_rows(pipe.unet_index, stacks,
                                       gains.to(pipe.device, pipe.dtype)):
            kernels, _, wall_ms, _, delta = profiled(
                lambda: pipe.unet(x, t, ctx, added_cond=added), 2, pipe.device)
        delta_ms, delta_n = sum(v[0] for v in delta.values()), sum(v[1] for v in delta.values())
        device_ms = sum(v[0] for v in kernels.values())
        served["lora_delta_per_unet_call"] = {"launches": delta_n, "device_ms": delta_ms,
                                              "unet_device_ms": device_ms, "wall_ms": wall_ms}
        log(f"[batched] per-row LoRA delta (2 slots) in one SDXL UNet call at 8 CFG rows on "
            f"{smi}: {delta_n:g} launches, {delta_ms:.3f} device-ms of the call's "
            f"{device_ms:.2f} ({wall_ms:.2f} ms wall under the profiler)")
        del pipe, stacks, x, ctx, added
        registry = None
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()

        # SD 1.5 512^2 in a registry of its own
        registry = Registry(torch.device(device), str(ROOT / ".no-models"), str(loras))
        registry.get_pipeline(sd15, allow_random_init=True)
        budget = coalesce_rows_limit(device, sd15, size15)
        log(f"[batched] {sd15} resident; a group holds at most {budget} images at {size15}^2")
        sd = dict(xl, model_name=sd15, height=size15, width=size15)

        def sd_job(tag, i, n=1):
            return dict(sd, id=f"{tag}-{i}", prompt=BATCH_PROMPTS[i % len(BATCH_PROMPTS)],
                        seed=9000 + i, parameters={**sd["parameters"],
                                                   "num_images_per_prompt": n})

        both("sd15_8", [sd_job("sd8", i) for i in range(8)], SD_UNET_LAUNCHES, size15)
        check(big_jobs * big_images <= budget, f"{big_jobs} x {big_images} images > {budget}")
        big = both("sd15_largest", [sd_job("sd64", i, big_images) for i in range(big_jobs)],
                   SD_UNET_LAUNCHES, size15)
        rows = {key[0][0] for key in paths["batched_sd15_largest"][1]["group_norm"][1]}
        log(f"[batched] the largest SD 1.5 pass: {big_jobs * big_images} images, GroupNorm at "
            f"batch rows {sorted(rows)}; {torch.cuda.max_memory_allocated() / 2**30 if device == 'cuda' else 0:.1f}"
            " GiB allocated at most so far")
        check(2 * big_jobs * big_images in rows or not hold,
              f"GroupNorm batch rows {sorted(rows)}")
        del big, registry
        gc.collect()
        return paths, served
    finally:
        shutil.rmtree(root, ignore_errors=True)


# --- phase 5, the ControlNet path ---

CN_SD15 = "lllyasviel/control_v11p_sd15_canny"
CN_QR = "monster-labs/control_v1p_sd15_qrcode_monster"
CN_SDXL = "diffusers/controlnet-canny-sdxl-1.0"
# no files under the path's root: the branch starts as it is trained from,
# every residual conv zero
CN_ZERO = "smoke/zero-init-controlnet"
# kernel launches of one ControlNet call: its down and mid blocks are the
# UNet's. SD 1.x: 14 attention (6 transformer layers in the down blocks
# and one in the mid block, a self- and a cross-attention each) and 27
# GroupNorm (11 resnets of two, 5 transformers); SDXL: 68 attention (4 + 20
# + 10 layers) and 21 GroupNorm (8 resnets of two, 5 transformers)
SD_CN_LAUNCHES = {"flash_attention": 14, "group_norm": 27}
XL_CN_LAUNCHES = {"flash_attention": 68, "group_norm": 21}


def serve_controlnet_path(smi: str, xl_launches: dict, device: str = "cuda",
                          sdxl: str = SDXL, sd15: str = SD15, size_xl: int = SIZE,
                          size15: int = 512, size_qr: int = 768, steps: int = STEPS,
                          pass_jobs: int = 4, hold: bool = True,
                          fillers=("test/tiny-sd", "test/tiny-xl", "test/tiny-inpaint")
                          ) -> tuple[dict, dict]:
    """Phase 5, the ControlNet path: a registry of its own over a temporary
    root holds SDXL and SD 1.5 on seeded random weights, and three
    ControlNets are written there from seeded tensors in every conv
    (`write_controlnet`: the canny ControlNets of SD 1.5 and SDXL and the QR
    monster, at their published configs). Through the worker, with the
    control, start and mask images served by the fake hive and each job's
    launches held to its UNet calls plus its ControlNet calls (the loop
    indices in the guidance window) x SD_CN_LAUNCHES or XL_CN_LAUNCHES:
    SD 1.5 `size15`^2 txt2img plain, then with the canny preprocessor on
    the served photo-like image, the same at scale 0 and with a zero-init
    branch (both the plain image bit for bit), with the window 0.25-0.75,
    img2img (strength 0.75, Euler ancestral) and 4-channel inpaint (DDIM)
    with the control image; the QR two-stage chain at `size_qr`^2 (the QR
    image served as the control image); SDXL `size_xl`^2 txt2img with its
    canny ControlNet; then `pass_jobs` SDXL txt2img jobs sharing that
    ControlNet and one control image as one coalesced pass, and the same
    jobs each alone. Then one bf16 ControlNet call of each model through
    the kernels against f32 on the plain path (phase 7's bound), its device
    time by the profiler, and an eviction: `fillers` push SDXL out, and its
    branch's device memory leaves with it. `hold` false only prints the
    launches (the CPU rehearsal)."""
    import gc
    import shutil
    import tempfile

    from chiaswarm_tpu_torch.registry import Registry

    on_card = torch.device(device).type == "cuda"

    def allocated():
        gc.collect()
        return torch.cuda.memory_allocated() if on_card else 0

    root = Path(tempfile.mkdtemp(prefix="chip-smoke-controlnet-"))
    try:
        registry = Registry(torch.device(device), str(root))
        t0 = time.perf_counter()
        pipes = {m: registry.get_pipeline(m, allow_random_init=True) for m in (sdxl, sd15)}
        log(f"[controlnet] {sdxl} and {sd15} resident in a registry of their own in "
            f"{time.perf_counter() - t0:.1f}s")
        files = {}
        for name, model, seed in ((CN_SD15, sd15, 61), (CN_QR, sd15, 62), (CN_SDXL, sdxl, 63)):
            t0 = time.perf_counter()
            files[name] = {"bytes": write_controlnet(root / name, pipes[model], seed),
                           "write_s": time.perf_counter() - t0}
            log(f"[controlnet] {name} for {model}: {files[name]['bytes']} bytes of fp16 "
                f"safetensors written in {files[name]['write_s']:.2f}s")
        common = {"negative_prompt": "blurry", "num_inference_steps": steps,
                  "guidance_scale": 7.0, "content_type": "image/png"}
        at15 = {**common, "model_name": sd15, "height": size15, "width": size15,
                "prompt": "a lighthouse on a cliff at dusk"}
        canny15 = {"controlnet_model_name": CN_SD15, "control_image_uri": "photo",
                   "preprocessor": "canny"}

        def txt15(job_id, seed=6000, **cn):
            return {**at15, "id": job_id, "workflow": "txt2img", "seed": seed,
                    "parameters": {"scheduler_type": "DPMSolverMultistepScheduler",
                                   **({"controlnet": {**canny15, **cn}} if cn else {})}}

        jobs15 = [
            ("cn_sd15_plain", "txt2img", txt15("cn-sd15-plain")),
            ("cn_sd15_txt2img", "txt2img", txt15("cn-sd15-txt2img", preprocessor="canny")),
            ("cn_sd15_scale0", "txt2img", txt15("cn-sd15-scale0",
                                                controlnet_conditioning_scale=0.0)),
            ("cn_sd15_zero_init", "txt2img", txt15("cn-sd15-zero-init",
                                                   controlnet_model_name=CN_ZERO)),
            ("cn_sd15_window", "txt2img", txt15("cn-sd15-window", 6001,
                                                control_guidance_start=0.25,
                                                control_guidance_end=0.75)),
            ("cn_sd15_img2img", "img2img", {
                **at15, "id": "cn-sd15-img2img", "workflow": "img2img", "seed": 6002,
                "strength": 0.75, "start_image_uri": "start",
                "parameters": {"scheduler_type": "EulerAncestralDiscreteScheduler",
                               "controlnet": {"controlnet_model_name": CN_SD15,
                                              "control_image_uri": "photo"}}}),
            ("cn_sd15_inpaint", "inpaint", {
                **at15, "id": "cn-sd15-inpaint", "workflow": "inpaint", "seed": 6003,
                "strength": 1.0, "start_image_uri": "start", "mask_image_uri": "mask",
                "parameters": {"scheduler_type": "DDIMScheduler",
                               "controlnet": {"controlnet_model_name": CN_SD15,
                                              "control_image_uri": "photo"}}}),
            ("cn_sd15_qr", "img2img", {
                **at15, "id": "cn-sd15-qr", "workflow": "txt2img", "seed": 6004,
                "height": size_qr, "width": size_qr, "prompt": "a walled garden in spring",
                "parameters": {"scheduler_type": "DPMSolverMultistepScheduler",
                               "controlnet": {"controlnet_model_name": CN_QR,
                                              "control_image_uri": "qr",
                                              "controlnet_conditioning_scale": 1.3,
                                              "parameters": {"controlnet_prepipeline_type":
                                                             "StableDiffusionPipeline"}}}}),
        ]
        cn_per_call = {CN_SD15: SD_CN_LAUNCHES, CN_QR: SD_CN_LAUNCHES, CN_ZERO: SD_CN_LAUNCHES,
                       CN_SDXL: XL_CN_LAUNCHES}
        paths, served = serve_counted(smi, registry, jobs15, {sd15: SD_UNET_LAUNCHES}, device,
                                      tag="controlnet", where="ControlNet path", hold=False,
                                      cn_per_call=cn_per_call)
        xl_jobs = [("cn_sdxl_txt2img", "txt2img", {
            **common, "id": "cn-sdxl-txt2img", "workflow": "txt2img", "model_name": sdxl,
            "seed": 6100, "height": size_xl, "width": size_xl,
            "prompt": "a lighthouse on a cliff at dusk",
            "parameters": {"scheduler_type": "DPMSolverMultistepScheduler",
                           "controlnet": {"controlnet_model_name": CN_SDXL,
                                          "control_image_uri": "photo", "preprocessor": "canny"}}})]
        xl_paths, xl_served = serve_counted(smi, registry, xl_jobs, {sdxl: xl_launches}, device,
                                            tag="controlnet", where="ControlNet path",
                                            hold=False, cn_per_call=cn_per_call)
        paths.update(xl_paths)
        served["jobs"].update(xl_served["jobs"])
        served["served_s"] += xl_served["served_s"]
        served["fma_bf16"].update(xl_served["fma_bf16"])
        got = served["jobs"]
        same = {kind: got[kind]["pixels_sha256"] == got["cn-sd15-plain"]["pixels_sha256"]
                for kind in ("cn-sd15-txt2img", "cn-sd15-scale0", "cn-sd15-zero-init")}
        log(f"[controlnet] SD 1.5 images equal to the plain job's bit for bit: "
            f"{json.dumps(same)}")
        check(same["cn-sd15-scale0"], "the ControlNet job at scale 0 differs from the plain job")
        check(same["cn-sd15-zero-init"], "the zero-init ControlNet changed the plain image")
        check(not same["cn-sd15-txt2img"], "the ControlNet left the SD 1.5 image unchanged")
        if hold:
            hold_launches(served, "ControlNet path")
        else:
            for job_id, job in got.items():
                log(f"[controlnet] {job_id}: launches {job['launches']}, predicted "
                    f"{job['predicted_launches']} (not held)")

        # the shared ControlNet pass: one branch call a step over every row
        shared = {**common, "workflow": "txt2img", "model_name": sdxl, "height": size_xl,
                  "width": size_xl, "parameters": {
                      "scheduler_type": "DPMSolverMultistepScheduler",
                      "controlnet": {"controlnet_model_name": CN_SDXL,
                                     "control_image_uri": "photo.jpg",
                                     "preprocessor": "canny"}}}
        pass_jobs = [dict(shared, id=f"cn-xl-pass-{i}", prompt=BATCH_PROMPTS[i],
                          seed=6200 + i) for i in range(pass_jobs)]
        photo = {"photo.jpg": image_bytes(photo_image(size_xl), "JPEG")}
        per_call = {k: xl_launches[k] + XL_CN_LAUNCHES[k] for k in xl_launches}
        results, launches, wall = serve_group(registry, pass_jobs, device, files=photo)
        coalesced = check_group("sdxl_controlnet", pass_jobs, results, launches, wall, per_call,
                                size_xl, True, hold)
        solo_jobs = [dict(j, id=f"{j['id']}-alone") for j in pass_jobs]
        results, solo_launches, wall = serve_group(registry, solo_jobs, device, max_coalesce=1,
                                                   files=photo)
        alone = check_group("sdxl_controlnet alone", solo_jobs, results, solo_launches, wall,
                            per_call, size_xl, False, hold)
        for cfg in (*coalesced["configs"].values(), *alone["configs"].values()):
            check(cfg["controlnet"] == CN_SDXL and cfg["controlnet_calls"] == steps,
                  f"pass member: controlnet {cfg.get('controlnet')}, "
                  f"{cfg.get('controlnet_calls')} branch calls")
        paths["cn_sdxl_pass"] = (len(pass_jobs), launches)
        served["pass"] = {"pass": coalesced["row"], "alone": alone["row"]}
        log(f"[controlnet] shared-ControlNet pass on {smi}: {coalesced['row']['images_per_s']:.3f}"
            f" images/s coalesced against {alone['row']['images_per_s']:.3f} alone "
            f"({coalesced['row']['images_per_s'] / alone['row']['images_per_s']:.2f}x); step "
            f"{coalesced['row']['unet_step_ms']:.1f} ms against {alone['row']['unet_step_ms']:.1f}"
            " ms a job alone (UNet and ControlNet)")

        # one branch call of each model: numerics and device time
        e2e, profile = {}, {}
        for model, name, size in ((sd15, CN_SD15, size15), (sdxl, CN_SDXL, size_xl)):
            branch = pipes[model].controlnet(name)
            if on_card:
                e2e[model] = end_to_end_bf16_check(pipes[model], size, ("controlnet",), 2,
                                                   branch=branch)
            profile[model] = profile_main_path(pipes[model], size, parts=("controlnet",),
                                               branch=branch)
            log_profile(profile[model], smi)
            if on_card:
                check_one_launch_per_call(profile[model])
        served.update(files=files, e2e=e2e, profile=profile)

        # an eviction on purpose: SDXL leaves with its ControlNet
        branch_bytes = sum(t.numel() * t.element_size()
                           for t in pipes[sdxl].controlnet(CN_SDXL).state_dict().values())
        model_bytes = pipeline_bytes(pipes[sdxl])
        del pipes, branch
        registry.get_pipeline(sd15)
        for filler in fillers[:-1]:
            registry.get_pipeline(filler)
        before = allocated()
        fifth = registry.get_pipeline(fillers[-1])
        after = allocated()
        check(sdxl not in registry.resident_models(),
              f"{sdxl} still resident: {registry.resident_models()}")
        expected = model_bytes + branch_bytes - pipeline_bytes(fifth)
        del fifth
        served["eviction"] = {"model_bytes": model_bytes, "branch_bytes": branch_bytes,
                              "allocated_before": before, "allocated_after": after,
                              "fall": before - after, "expected_fall": expected}
        log(f"[controlnet] {fillers[-1]} evicted {sdxl}: allocated {before} -> {after}, a fall "
            f"of {before - after} against {expected} expected ({model_bytes} of weights and "
            f"{branch_bytes} of its ControlNet, less {fillers[-1]}'s)")
        if on_card:
            # the caching allocator counts whole blocks, which round a
            # tensor's bytes up (by up to a megabyte past a large one's)
            freed = model_bytes + branch_bytes
            check(expected - branch_bytes / 4 <= before - after <= expected + 0.02 * freed,
                  f"allocated memory fell by {before - after} bytes, not about {expected}")
        del registry
        gc.collect()
        return paths, served
    finally:
        shutil.rmtree(root, ignore_errors=True)


# --- the preprocessors' detectors (phase 3 checks, phase 5 serving) ---

DPT_MODEL = "Intel/dpt-large"
POSE_MODEL = "lllyasviel/ControlNet-openpose"
ANNOTATORS = "lllyasviel/Annotators"
ZOE_MODEL = "Intel/zoedepth-nyu"
UPERNET_MODEL = "openmmlab/upernet-convnext-small"
CN_DEPTH = "lllyasviel/control_v11f1p_sd15_depth"
CN_DEPTH_XL = "diffusers/controlnet-depth-sdxl-1.0"
# the annotators' published file names under ANNOTATORS
HED_FILE = "ControlNetHED.pth"
PIDINET_FILE = "table5_pidinet.pth"
MLSD_FILE = "mlsd_large_512_fp32.pth"
LINEART_FILE = "sk_model.pth"


def seeded_detector(factory, seed: int, device="cpu") -> torch.nn.Module:
    """`factory()` in f32 on `device` with seeded weights: every matrix and
    kernel N(0, 1/fan_in), LayerNorm scales N(1, 0.1), layer-scale lambdas
    N(0.1, 0.02), tokens and position tables N(0, 0.02), biases and other
    vectors N(0, 0.1), so that no branch is zero and no norm is the
    identity."""
    with torch.device("meta"):
        module = factory()
    module = module.to_empty(device=device).float()
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            owner = module.get_submodule(name.rsplit(".", 1)[0]) if "." in name else module
            leaf = name.rsplit(".", 1)[-1]
            if isinstance(owner, torch.nn.LayerNorm) and leaf == "weight":
                p.normal_(1.0, 0.1, generator=gen)
            elif leaf in ("lambda_1", "lambda_2", "layer_scale_parameter"):
                p.normal_(0.1, 0.02, generator=gen)
            elif leaf in ("cls_token", "position_embeddings"):
                p.normal_(0.0, 0.02, generator=gen)
            elif p.ndim >= 2:
                p.normal_(0.0, p[0].numel() ** -0.5, generator=gen)
            else:
                p.normal_(0.0, 0.1, generator=gen)
    return module


def _cpu_state(module, dtype=torch.float32) -> dict:
    return {k: v.detach().to("cpu", dtype).contiguous() for k, v in module.state_dict().items()}


def _batchnorm(channels: int, gen: torch.Generator) -> dict:
    return {"weight": torch.rand(channels, generator=gen) + 0.5,
            "bias": torch.randn(channels, generator=gen) * 0.1,
            "running_mean": torch.randn(channels, generator=gen) * 0.1,
            "running_var": torch.rand(channels, generator=gen) + 0.5,
            "num_batches_tracked": torch.tensor(0)}


def published_mlsd(folded: dict, seed: int) -> dict:
    """M-LSD's published state from a folded one: each conv followed by a
    BatchNorm at the next index (the trunk's convs without bias), the
    head's last conv as it is."""
    import re

    gen = torch.Generator().manual_seed(seed)
    out = {}
    for key, w in folded.items():
        if not key.endswith(".weight"):
            continue
        conv = key[:-len(".weight")]
        out[key] = w
        m = re.match(r"(.*\.)(\d+)$", conv)
        if m is None:  # block23.conv3
            out[f"{conv}.bias"] = folded[f"{conv}.bias"]
            continue
        if not conv.startswith("backbone."):
            out[f"{conv}.bias"] = folded[f"{conv}.bias"]
        bn = f"{m.group(1)}{int(m.group(2)) + 1}"
        out.update({f"{bn}.{k}": v for k, v in _batchnorm(w.shape[0], gen).items()})
    return out


def published_upernet(folded: dict, seed: int) -> dict:
    """UperNet's published state from a folded one: each decode-head conv
    (not the classifier) without bias and followed by its BatchNorm, and
    an auxiliary-head tensor, which the loaders drop."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for key, v in folded.items():
        if key.startswith("decode_head.") and key.endswith(".conv.bias"):
            continue
        out[key] = v
        if key.startswith("decode_head.") and key.endswith(".conv.weight"):
            module = key[:-len(".conv.weight")]
            out.update({f"{module}.batch_norm.{k}": t
                        for k, t in _batchnorm(v.shape[0], gen).items()})
    out["auxiliary_head.classifier.weight"] = torch.randn(4, 8, 1, 1, generator=gen)
    return out


def published_pidinet(state: dict, seed: int) -> dict:
    """PiDiNet's published checkpoint from a seeded state: raw 3x3 kernels
    for the 'rd' blocks, under DataParallel's `module.` prefix in a
    `state_dict` wrapper, as table5_pidinet.pth is."""
    from chiaswarm_tpu_torch.models import pidinet

    gen = torch.Generator().manual_seed(seed)
    raw = dict(state)
    for name, layer, _, _ in pidinet._blocks():
        if pidinet.CARV4[layer] == "rd":
            w = raw[f"{name}.conv1.weight"]
            raw[f"{name}.conv1.weight"] = torch.randn(w.shape[0], 1, 3, 3, generator=gen) / 3.0
    return {"state_dict": {f"module.{k}": v for k, v in raw.items()}}


def write_detectors(root: Path, seed: int = 0, *, tiny: bool = False, depth_model: str = DPT_MODEL,
                    pose_model: str = POSE_MODEL, device="cpu", skip=()) -> dict:
    """Every detector of the preprocessors from seeded tensors, in its
    published layout under `root`: transformers safetensors (fp16, with the
    keys the graph does not read) and config.json for DPT, ZoeDepth and
    UperNet (its BatchNorms unfolded); lllyasviel's f32 pickles under
    Annotators (ControlNetHED.pth, table5_pidinet.pth with raw pixel-
    difference kernels, mlsd_large_512_fp32.pth with its BatchNorms,
    sk_model.pth) and the pose model's body_pose_model.pth with flat
    caffe-style keys. `tiny` writes the tiny configs (TINY_DPT, TINY_HED,
    TINY_LINEART, TINY_ZOE, TINY_UPERNET; PiDiNet and M-LSD have one
    width); a test pose name gets no file. `skip` leaves detectors out
    ("dpt", "hed", "pose", "pidinet", "mlsd", "lineart", "zoe",
    "upernet"). -> {detector: bytes}."""
    from safetensors.torch import save_file

    from chiaswarm_tpu_torch.models import depth, hed, lineart, mlsd, pidinet, pose
    from chiaswarm_tpu_torch.models import segmentation as seg
    from chiaswarm_tpu_torch.models import zoedepth as zoe
    from chiaswarm_tpu_torch.weights import is_test_model

    def safetensors(name: str, state: dict, config: dict) -> int:
        folder = root / name
        folder.mkdir(parents=True, exist_ok=True)
        save_file({k: v.to(torch.float16) if v.is_floating_point() else v
                   for k, v in state.items()}, str(folder / "model.safetensors"))
        (folder / "config.json").write_text(json.dumps(config))
        return (folder / "model.safetensors").stat().st_size

    def pickle(name: str, file: str, state: dict) -> int:
        (root / name).mkdir(parents=True, exist_ok=True)
        torch.save(state, str(root / name / file))
        return (root / name / file).stat().st_size

    written = {}
    if "dpt" not in skip:
        cfg = depth.TINY_DPT if tiny else depth.DPTConfig()
        state = _cpu_state(seeded_detector(lambda: depth.DPTDepthModel(cfg), seed, device))
        d = cfg.hidden_size
        # published keys the graph leaves unread
        state["dpt.layernorm.weight"], state["dpt.layernorm.bias"] = torch.ones(d), torch.zeros(d)
        for conv in ("convolution1", "convolution2"):
            prefix = f"neck.fusion_stage.layers.0.residual_layer1.{conv}"
            state[f"{prefix}.weight"] = torch.zeros(cfg.fusion_dim, cfg.fusion_dim, 3, 3)
            state[f"{prefix}.bias"] = torch.zeros(cfg.fusion_dim)
        written["dpt"] = safetensors(depth_model, state, {"model_type": "dpt",
                                                          "hidden_size": d})
    if "hed" not in skip:
        state = _cpu_state(seeded_detector(
            lambda: hed.HEDNet(hed.TINY_HED if tiny else hed.HEDConfig()), seed + 1, device))
        # the learned mean near mid-grey, He-scaled convs (so that 13 ReLU
        # layers keep the scale of their input) and small projections: edge
        # logits of a few units, so the sigmoid neither saturates on 0..255
        # input nor sits flat at one half
        state["norm"] = state["norm"] * 10.0 + 127.5
        for key in [k for k in state if ".convs." in k and k.endswith(".weight")]:
            state[key] = state[key] * 2.0 ** 0.5
        for key in [k for k in state if ".projection." in k]:
            state[key] = state[key] / 64.0
        written["hed"] = pickle(ANNOTATORS, HED_FILE, state)
    if "pose" not in skip and not is_test_model(pose_model):
        # kernels 1.6x the seeded scale: the 17 ReLU stages then keep the
        # heatmaps' scale, and the PAF grouping finds a figure to draw
        state = {k: v * 1.6 if k.endswith(".weight") else v for k, v in
                 _cpu_state(seeded_detector(pose.OpenposeBody, seed + 2, device)).items()}
        written["pose"] = pickle(pose_model, "body_pose_model.pth",
                                 {k.split(".", 1)[1]: v for k, v in state.items()})
    if "pidinet" not in skip:
        state = _cpu_state(seeded_detector(pidinet.PiDiNet, seed + 3, device))
        written["pidinet"] = pickle(ANNOTATORS, PIDINET_FILE, published_pidinet(state, seed + 3))
    if "mlsd" not in skip:
        state = _cpu_state(seeded_detector(mlsd.MLSDNet, seed + 4, device))
        written["mlsd"] = pickle(ANNOTATORS, MLSD_FILE, published_mlsd(state, seed + 4))
    if "lineart" not in skip:
        cfg = lineart.TINY_LINEART if tiny else lineart.LineartConfig()
        written["lineart"] = pickle(ANNOTATORS, LINEART_FILE, _cpu_state(seeded_detector(
            lambda: lineart.LineartGenerator(cfg), seed + 5, device)))
    if "zoe" not in skip:
        cfg = zoe.TINY_ZOE if tiny else zoe.ZoeConfig()
        written["zoe"] = safetensors(ZOE_MODEL, _cpu_state(seeded_detector(
            lambda: zoe.ZoeDepthModel(cfg), seed + 6, device)), zoe.config_json(cfg))
    if "upernet" not in skip:
        cfg = seg.TINY_UPERNET if tiny else seg.UperNetConfig()
        state = _cpu_state(seeded_detector(lambda: seg.UperNetSegmenter(cfg), seed + 7, device))
        written["upernet"] = safetensors(UPERNET_MODEL, published_upernet(state, seed + 7),
                                         seg.config_json(cfg))
    return written


# DPT-large's attention: (1, 577, 16, 64) a call, 24 calls; the other
# detectors launch no kernel (ZoeDepth's attention, with its relative
# position bias, is plain torch, as in the JAX package)
DPT_ATTENTION = ((1, 577, 16, 64), (1, 577, 16, 64))
DPT_LAUNCHES = {"flash_attention": 24, "group_norm": 0}
PREPROCESSORS = ("depth", "normal bae", "depth estimator", "scribble", "soft edge", "openpose",
                 "mlsd", "lineart", "zoe depth", "segmentation")
# the kernels' launches of one condition image, by preprocessor (with every
# detector's weights present)
PREPROCESSOR_LAUNCHES = {name: DPT_LAUNCHES for name in ("depth", "normal bae",
                                                         "depth estimator")}


def preprocessor_checks(gen) -> None:
    """Phase 3 at DPT-large's attention shape, (1, 577, 16, 64) in bf16 and
    f32 (577 rows fill no tile: the last Q and KV tiles are ragged); bf16
    must take the tensor-core route (`wgmma-d64`)."""
    q, k = DPT_ATTENTION
    for dtype in (torch.bfloat16, torch.float32):
        row = attention_case(q, k, dtype, gen, timed=False)
        if dtype == torch.bfloat16:
            check(row["route"] in (None, "wgmma-d64"),
                  f"DPT attention bf16 took route {row['route']}, not wgmma-d64")
        log(f"[check] flash_attention q{q} kv{k} {row['dtype']} route {row['route']} "
            f"(DPT-large): max_abs_err {row['max_abs_err']:.3g}"
            + (f", RMS err {row['rms_err']:.3g}" if "rms_err" in row else "")
            + f" (bound {row['bound']})")


def _flat(out) -> torch.Tensor:
    """A detector network's output(s) as one f32 vector."""
    outs = out if isinstance(out, (list, tuple)) else [out]
    return torch.cat([o.float().reshape(-1) for o in outs])


def detector_checks(det, image, smi: str, on_card: bool) -> dict:
    """Step 3 of the preprocessor path, each detector alone at its published
    widths: built from its files (load seconds, bytes on disk, resident
    device bytes), then one call on `image`'s input: its output in bf16
    through the kernels against the same weights in f32 on the plain path,
    the relative RMS error at most E2E_RATIO x that of the plain path in
    bf16 (the rule of the UNet and VAE checks); the ms of a call by CUDA
    events over back-to-back calls (host gaps included: not device time)
    and its attention launches (24 for DPT)."""
    import copy

    from chiaswarm_tpu_torch.ops.flash_attention import COUNTER as FA_COUNTER
    from chiaswarm_tpu_torch.weights import is_test_model

    rows = {}
    for kind in ("depth", "hed", "pose", "pidinet", "mlsd", "lineart", "zoe", "segmenter"):
        allocated = torch.cuda.memory_allocated() if on_card else 0
        t0 = time.perf_counter()
        detector = getattr(det, kind)()
        load_s = time.perf_counter() - t0
        check(detector is not None and (detector.weights_source == "checkpoint"
                                        or is_test_model(getattr(detector, "model_name", ""))),
              f"the {kind} detector did not load its files")
        resident = (torch.cuda.memory_allocated() - allocated) if on_card else 0
        source = Path(detector.source)
        file_bytes = (sum(f.stat().st_size for f in source.glob("*.safetensors"))
                      if source.is_dir() else source.stat().st_size if source.exists() else 0)
        px = detector.pixels(detector.prepare(image))
        with torch.inference_mode():
            before = FA_COUNTER.launches
            kernels = _flat(detector.model(px))
            launches = FA_COUNTER.launches - before
            with plain_path():
                plain = _flat(detector.model(px))
                wide = copy.deepcopy(detector.model).float()
                exact = _flat(wide(px.float()))
                del wide
            ms = time_ms(lambda: detector.model(px), min_total_ms=50.0, max_iters=10) \
                if on_card else float("nan")
        scale = rms(exact)
        row = {"load_s": load_s, "file_bytes": file_bytes, "param_bytes": detector.param_bytes,
               "resident_bytes": resident, "event_ms": ms, "attention_launches": launches,
               "input": list(px.shape), "dtype": str(detector.dtype)[6:],
               "rel_rms_err": rms(kernels - exact) / scale,
               "plain_bf16_rel_rms_err": rms(plain - exact) / scale,
               "finite": bool(torch.isfinite(kernels).all())}
        rows[kind] = row
        log(f"[detector] {kind} ({type(detector.model).__name__}, input {row['input']} "
            f"{row['dtype']}) on {smi}: loaded in {load_s:.2f}s from {file_bytes} bytes, "
            f"resident {resident} device bytes ({detector.param_bytes} of parameters); "
            f"{ms:.3f} ms a call by events, {launches} attention launches a call; relative RMS "
            f"err {row['rel_rms_err']:.4g} against f32 (plain bf16 "
            f"{row['plain_bf16_rel_rms_err']:.4g}, bound {E2E_RATIO}x that)")
        check(row["finite"], f"the {kind} detector's output is not finite")
        if on_card:
            check(row["rel_rms_err"] <= E2E_RATIO * row["plain_bf16_rel_rms_err"] + 1e-7,
                  f"{kind}: bf16 kernel path error {row['rel_rms_err']} > {E2E_RATIO} x the "
                  f"plain bf16 path's {row['plain_bf16_rel_rms_err']}")
            check(launches == (DPT_LAUNCHES["flash_attention"] if kind == "depth" else 0),
                  f"{kind}: {launches} attention launches a call")
    return rows


def serve_preprocessor_path(smi: str, xl_launches: dict, device: str = "cuda",
                            sdxl: str = SDXL, sd15: str = SD15, size15: int = 512,
                            size_xl: int = SIZE, steps: int = STEPS, tiny: bool = False,
                            hold: bool = True) -> tuple[dict, dict]:
    """Phase 5, the preprocessors that run a model: a registry of its own
    over a temporary root holds SD 1.5 and SDXL on seeded random weights,
    the depth ControlNets of both (lllyasviel/control_v11f1p_sd15_depth,
    diffusers/controlnet-depth-sdxl-1.0 configs) and every detector in
    its published layout (`write_detectors`; `tiny` for the CPU rehearsal).
    Each detector alone (`detector_checks`); then, through the worker,
    one SD 1.5 `size15`^2 ControlNet txt2img job on the served photo-like
    image per name of PREPROCESSORS and a plain ControlNet job beside
    them, and an SDXL `size_xl`^2 depth job: each envelope checked as the
    ControlNet path checks it, its launches the plain ControlNet job's
    plus the detector's, no `degraded_preprocessors`. Then a stitch job
    of three served images. Then a degraded root read by the detectors:
    without DPT a depth job ends in a fatal envelope naming the weights;
    without HED scribble is served by the Laplacian, not flagged; mlsd,
    lineart and segmentation by their stand-ins, flagged; with DPT copied
    in, zoe depth by DPT, flagged; with M-LSD's file copied in, the next
    mlsd job by M-LSD (the mtime negative cache), not flagged."""
    import gc
    import shutil
    import tempfile

    import numpy as np

    from PIL import Image

    from chiaswarm_tpu_torch import job_arguments
    from chiaswarm_tpu_torch.pipelines import aux_models
    from chiaswarm_tpu_torch.pre_processors.controlnet import preprocess_image
    from chiaswarm_tpu_torch.registry import Registry

    on_card = torch.device(device).type == "cuda"
    root = Path(tempfile.mkdtemp(prefix="chip-smoke-preprocessors-"))
    degraded = Path(tempfile.mkdtemp(prefix="chip-smoke-degraded-"))
    try:
        registry = Registry(torch.device(device), str(root))
        pipes = {m: registry.get_pipeline(m, allow_random_init=True) for m in (sdxl, sd15)}
        files = {}
        for name, model, seed in ((CN_DEPTH, sd15, 81), (CN_DEPTH_XL, sdxl, 82)):
            files[name] = write_controlnet(root / name, pipes[model], seed)
        # the tiny rehearsal's detectors: test names, which the loaders size
        # as tiny
        names = ({"depth_model": "test/tiny-dpt", "pose_model": "test/tiny-pose"} if tiny
                 else {"depth_model": DPT_MODEL, "pose_model": POSE_MODEL})
        t0 = time.perf_counter()
        written = write_detectors(root, 90, tiny=tiny, device=device, **names)
        log(f"[preprocessor] detectors written from seeded tensors in "
            f"{time.perf_counter() - t0:.1f}s: {json.dumps(written)} bytes")
        det = aux_models.Detectors(device, str(root), **names)
        photo = photo_image(size15)
        detectors = detector_checks(det, photo, smi, on_card)

        def as_served(side):
            """The photo-like image as a job's worker decodes it (served as JPEG)."""
            return Image.open(io.BytesIO(image_bytes(photo_image(side), "JPEG"))).convert("RGB")

        condition_s, direct = {}, {}
        for name in PREPROCESSORS:
            preprocess_image(photo, name, detectors=det)  # warm
            t0 = time.perf_counter()
            cond = np.asarray(preprocess_image(photo, name, detectors=det))
            condition_s[name] = time.perf_counter() - t0
            direct[(name, size15)] = np.asarray(preprocess_image(as_served(size15), name,
                                                                 detectors=det))
            log(f"[preprocessor] {name} condition image {cond.shape} on {smi}: "
                f"{condition_s[name]:.4f}s (host and device, warm); {int(cond.min())}.."
                f"{int(cond.max())}, mean {float(cond.mean()):.1f}")
            # random weights may find no figure: a black pose map is then right
            check(cond.shape == (size15, size15, 3) and (
                name == "openpose" or int(cond.max()) != int(cond.min())),
                f"the {name} condition image is {cond.shape}, {cond.min()}..{cond.max()}")

        common = {"negative_prompt": "blurry", "num_inference_steps": steps,
                  "guidance_scale": 7.0, "content_type": "image/png"}

        def cn_job(job_id, model, size, cn_name, preprocessor=None, seed=7000):
            cn = {"controlnet_model_name": cn_name, "control_image_uri": "photo"}
            if preprocessor:
                cn["preprocessor"] = preprocessor
            return {**common, "id": job_id, "workflow": "txt2img", "model_name": model,
                    "seed": seed, "height": size, "width": size,
                    "prompt": "a lighthouse on a cliff at dusk",
                    "parameters": {"scheduler_type": "DPMSolverMultistepScheduler",
                                   "controlnet": cn}}

        kind_of = {name: "pre_" + name.replace(" ", "_") for name in PREPROCESSORS}
        jobs15 = [("pre_plain_controlnet", "txt2img",
                   cn_job("pre-plain", sd15, size15, CN_DEPTH))]
        jobs15 += [(kind_of[name], "txt2img",
                    cn_job(f"pre-{kind_of[name][4:]}", sd15, size15, CN_DEPTH, name))
                   for name in PREPROCESSORS]
        cn_per_call = {CN_DEPTH: SD_CN_LAUNCHES, CN_DEPTH_XL: XL_CN_LAUNCHES}
        direct[("depth", size_xl)] = np.asarray(preprocess_image(as_served(size_xl), "depth",
                                                                 detectors=det))
        # the condition image each served job's arguments carry (the
        # envelope does not carry it: ROADMAP §3), recorded where the
        # worker formats the job
        received, preprocess = {}, job_arguments._preprocess

        def recording(args, image, preprocessor, detectors):
            out = preprocess(args, image, preprocessor, detectors)
            received.setdefault((preprocessor, image.width), []).append(np.asarray(out))
            return out

        job_arguments._preprocess = recording
        try:
            paths, served = serve_counted(smi, registry, jobs15, {sd15: SD_UNET_LAUNCHES},
                                          device, tag="preprocessor", where="preprocessor path",
                                          hold=False, cn_per_call=cn_per_call,
                                          detector_launches=PREPROCESSOR_LAUNCHES,
                                          settings_kw=names)
            xl_jobs = [("pre_sdxl_depth", "txt2img",
                        cn_job("pre-sdxl-depth", sdxl, size_xl, CN_DEPTH_XL, "depth", 7100))]
            xl_paths, xl_served = serve_counted(smi, registry, xl_jobs, {sdxl: xl_launches},
                                                device, tag="preprocessor",
                                                where="preprocessor path", hold=False,
                                                cn_per_call=cn_per_call,
                                                detector_launches=PREPROCESSOR_LAUNCHES,
                                                settings_kw=names)
        finally:
            job_arguments._preprocess = preprocess
        agreement = {}
        for (name, side), want in direct.items():
            got_images = received.get((name, side), [])
            check(got_images, f"no served {side}^2 job received a {name} condition image")
            for got_image in got_images:
                diff = np.abs(got_image.astype(int) - want.astype(int))
                share = float((diff == 0).mean())
                agreement[f"{name} {side}"] = min(share, agreement.get(f"{name} {side}", 1.0))
                check(got_image.shape == want.shape and int(diff.max()) <= 1
                      and share >= 0.999,
                      f"the served {name} job's condition image is not the preprocessor's: "
                      f"{share:.5f} of pixels equal, max diff {int(diff.max())}")
        log(f"[preprocessor] served condition images against direct calls on the decoded "
            f"input, share of pixels equal: {json.dumps(agreement)}")
        paths.update(xl_paths)
        served["jobs"].update(xl_served["jobs"])
        served["fma_bf16"].update(xl_served["fma_bf16"])
        got = served["jobs"]
        plain = got["pre-plain"]["launches"]
        for job_id, job in got.items():
            check(not job["degraded_preprocessors"],
                  f"{job_id}: degraded_preprocessors {job['degraded_preprocessors']}")
            if on_card and job["model"] == sd15 and job["preprocessor"]:
                extra = PREPROCESSOR_LAUNCHES.get(job["preprocessor"], {})
                want = {k: plain[k] + extra.get(k, 0) for k in plain}
                check(job["launches"] == want, f"{job_id}: launches {job['launches']}, not the "
                      f"plain ControlNet job's {plain} plus the detector's {extra}")
        if hold:
            hold_launches(served, "preprocessor path")
        else:
            for job_id, job in got.items():
                log(f"[preprocessor] {job_id}: launches {job['launches']}, predicted "
                    f"{job['predicted_launches']} (not held)")

        # stitch: three images the fake hive serves, one mosaic
        tiles = {f"tile-{i}.jpg": image_bytes(photo_image(96 + 64 * i), "JPEG")
                 for i in range(3)}
        stitch = {"id": "pre-stitch", "workflow": "stitch", "model_name": "none",
                  "content_type": "image/png",
                  "jobs": [{"id": f"src-{i}", "resultUri": name}
                           for i, name in enumerate(tiles)]}
        results, _, wall = serve_group(registry, [stitch], device, max_coalesce=1, files=tiles)
        env = results["pre-stitch"]
        check(not env.get("fatal_error"), f"stitch: {env['pipeline_config']}")
        mosaic = decode_artifact(env["artifacts"]["primary"])
        cfg = env["pipeline_config"]
        check(mosaic.shape == (512, 512, 3) and (cfg["rows"], cfg["cols"]) == (2, 2)
              and [r["job_id"] for r in cfg["image_map"]] == ["src-0", "src-1", "src-2"],
              f"stitch: mosaic {mosaic.shape}, {cfg}")
        served["stitch"] = {"wall_s": wall, "rows": cfg["rows"], "cols": cfg["cols"]}
        log(f"[preprocessor] stitch job on {smi}: {wall:.2f}s, a {mosaic.shape[1]}x"
            f"{mosaic.shape[0]} mosaic of {len(tiles)} tiles")

        # the degraded root: detectors absent, then arriving
        photo_file = {"photo.jpg": image_bytes(photo, "JPEG")}
        fatal = cn_job("pre-no-dpt", sd15, size15, CN_DEPTH, "depth", 7200)
        fatal["parameters"]["controlnet"]["control_image_uri"] = "photo.jpg"
        results, _, _ = serve_group(registry, [fatal], device, max_coalesce=1, files=photo_file,
                                    settings_kw={"model_root_dir": str(degraded)})
        env = results["pre-no-dpt"]
        error = env["pipeline_config"].get("error", "")
        check(env.get("fatal_error") is True and "Intel/dpt-large" in error
              and "not present" in error, f"depth without DPT: {env['pipeline_config']}")
        log(f"[preprocessor] depth without DPT: fatal envelope, {error!r}")
        expect = {"scribble": None, "mlsd": ["mlsd"], "lineart": ["lineart"],
                  "segmentation": ["segmentation"]}
        degraded_jobs = [(f"degraded_{name}", "txt2img",
                          cn_job(f"degraded-{name}", sd15, size15, CN_DEPTH, name, 7300 + i))
                         for i, name in enumerate(expect)]
        d_paths, d_served = serve_counted(smi, registry, degraded_jobs, {sd15: SD_UNET_LAUNCHES},
                                          device, tag="degraded", where="degraded root",
                                          hold=hold, cn_per_call=cn_per_call,
                                          settings_kw={**names, "model_root_dir": str(degraded)})
        shutil.copytree(root / names["depth_model"], degraded / names["depth_model"])
        zoe_jobs = [("degraded_zoe_depth", "txt2img",
                     cn_job("degraded-zoe-depth", sd15, size15, CN_DEPTH, "zoe depth", 7400))]
        z_paths, z_served = serve_counted(smi, registry, zoe_jobs, {sd15: SD_UNET_LAUNCHES},
                                          device, tag="degraded", where="degraded root",
                                          hold=hold, cn_per_call=cn_per_call,
                                          detector_launches={"zoe depth": DPT_LAUNCHES},
                                          settings_kw={**names, "model_root_dir": str(degraded)})
        (degraded / ANNOTATORS).mkdir(parents=True, exist_ok=True)
        shutil.copy(root / ANNOTATORS / MLSD_FILE, degraded / ANNOTATORS / MLSD_FILE)
        back_jobs = [("degraded_mlsd_back", "txt2img",
                      cn_job("degraded-mlsd-back", sd15, size15, CN_DEPTH, "mlsd", 7500))]
        b_paths, b_served = serve_counted(smi, registry, back_jobs, {sd15: SD_UNET_LAUNCHES},
                                          device, tag="degraded", where="degraded root",
                                          hold=hold, cn_per_call=cn_per_call,
                                          settings_kw={**names, "model_root_dir": str(degraded)})
        expect.update({"zoe depth": ["zoe depth"], "mlsd-back": None})
        flags = {}
        for part in (d_served, z_served, b_served):
            for job_id, job in part["jobs"].items():
                flags[job_id.removeprefix("degraded-").replace("zoe-depth", "zoe depth")] = \
                    job["degraded_preprocessors"]
        log(f"[preprocessor] degraded root: degraded_preprocessors {json.dumps(flags)}")
        check(flags == expect, f"degraded_preprocessors {flags}, not {expect}")
        for part in (d_paths, z_paths, b_paths):
            paths.update(part)
        served["degraded"] = flags
        served["detectors"] = detectors
        served["condition_s"] = condition_s
        served["condition_agreement"] = agreement
        served["files"] = {**files, **written}
        del pipes, registry
        gc.collect()
        return paths, served
    finally:
        aux_models.clear()
        shutil.rmtree(root, ignore_errors=True)
        shutil.rmtree(degraded, ignore_errors=True)


# --- the upscale and safety path (phase 3 checks, phase 5 serving) ---

UPSCALER = "stabilityai/sd-x2-latent-upscaler"
CHECKER = "CompVis/stable-diffusion-safety-checker"
# the chained upscale's steps (the pipeline's default, as in JAX)
UPSCALE_STEPS = 20
# kernel launches of one K-UNet call (4 cross-attention blocks at each of
# the three attention levels on the way down and up, the deepest level's
# with a self-attention too; its AdaGroupNorm is no GroupNorm kernel) and
# of one checker call (24 ViT layers, any number of images)
K_UNET_LAUNCHES = {"flash_attention": 32, "group_norm": 0}
CHECKER_LAUNCHES = {"flash_attention": 24, "group_norm": 0}


def k_unet_attention_shapes(side: int, rows: int = 1) -> Counter:
    """{(q shape, kv shape, dtype): launches} of one bf16 K-UNet call on
    `side`^2 latents (twice the job's) at the published config
    (KUpscalerConfig): one cross-attention a layer where the level has
    cross-attention, with a self-attention too where the config says;
    on the way up each level's last block has the next lower level's
    width, as its resnet narrows. 77 context tokens."""
    from chiaswarm_tpu_torch.models.k_upscaler import KUpscalerConfig

    cfg = KUpscalerConfig()
    widths, layers, d = cfg.block_out_channels, cfg.layers_per_block, cfg.attention_head_dim
    shapes = Counter()

    def add(level, width, self_attention, count):
        q = (rows, (side >> level) ** 2, width // d, d)
        shapes[(q, (rows, 77, width // d, d), torch.bfloat16)] += count
        if self_attention:
            shapes[(q, q, torch.bfloat16)] += count

    for i in range(len(widths)):
        if cfg.cross_attention[i]:
            add(i, widths[i], cfg.down_self_attention[i], layers)
    for lvl in range(len(widths)):
        i = len(widths) - 1 - lvl
        if cfg.cross_attention[i]:
            add(i, widths[i], cfg.up_self_attention[lvl], layers - 1)
            add(i, widths[max(i - 1, 0)], cfg.up_self_attention[lvl], 1)
    return shapes


def vae_norms(size: int, decode: bool) -> list:
    """Every distinct GroupNorm call (x, silu, eps) of one SD VAE decode to
    (or encode from) a `size`^2 image, batch 1: the mid block's resnets and
    attention norm, each up (down) block's resnets, the output norm."""
    s = size // 8
    if decode:
        shapes = [(s, 512), (2 * s, 512), (4 * s, 512), (4 * s, 256), (8 * s, 256),
                  (8 * s, 128)]
    else:
        shapes = [(8 * s, 128), (4 * s, 128), (4 * s, 256), (2 * s, 256), (2 * s, 512),
                  (s, 512)]
    return [((1, n, n, c), True, 1e-6) for n, c in shapes] + [((1, s, s, 512), False, 1e-6)]


def upscale_checks(gen) -> None:
    """Phase 3 at the shapes of the upscale and safety path, in bf16 and
    f32: the checker's self-attention (B, 257, 16, 64) for one and two
    images (257 rows: ragged in both Q and KV tiles); the K-UNet's
    attention on the 2x latents of an SD 1.5 512^2 job (128^2) and of an
    SDXL 1024^2 job (256^2); the upscaler VAE's mid-block attention at
    4096, 16384 and 65536 tokens (the 2048^2 decode), compared over query
    chunks of the plain version, every row against all keys; and every
    GroupNorm call of its encode from 512^2 and 1024^2 and its decode to
    1024^2 and 2048^2 (up to [1, 2048, 2048, 256], 2^31 bytes in bf16).
    Each bf16 attention call must report the tensor-core route."""
    attention = Counter({((b, 257, 16, 64), (b, 257, 16, 64), torch.bfloat16): 1
                         for b in (1, 2)})
    attention.update(k_unet_attention_shapes(128))
    attention.update(k_unet_attention_shapes(256))
    for tokens in (4096, 16384, 65536):
        q = (1, tokens, 1, 512)
        attention[(q, q, torch.bfloat16)] += 1
    for q_shape, k_shape, _ in attention:
        for dtype in (torch.bfloat16, torch.float32):
            row = attention_case(q_shape, k_shape, dtype, gen, timed=False)
            log(f"[check] flash_attention q{q_shape} kv{k_shape} {row['dtype']} route "
                f"{row['route']} (upscale path): max_abs_err {row['max_abs_err']:.3g}"
                + (f", RMS err {row['rms_err']:.3g}" if "rms_err" in row else "")
                + f" (bound {row['bound']})")
    norms = {}
    for size, decode in ((512, False), (1024, False), (1024, True), (2048, True)):
        norms.update(dict.fromkeys(vae_norms(size, decode)))
    for x_shape, silu, eps in norms:
        for dtype in (torch.bfloat16, torch.float32):
            row = gn_case(x_shape, dtype, silu, gen, timed=False, eps=eps)
            log(f"[check] group_norm x{x_shape} {row['dtype']} silu={silu} eps {eps:g} "
                f"(upscale path): max_abs_err {row['max_abs_err']:.3g} (bound {row['bound']})"
                + (f", on chip: {row['on_chip']}" if "on_chip" in row else ""))
            torch.cuda.empty_cache()


def write_upscaler(pipe, repo: Path, scheduler: dict | None = None, dtype=None) -> int:
    """A LatentUpscalePipeline's weights as diffusers-layout safetensors
    under `repo` (unet/, text_encoder/, vae/, each with the config.json
    whose fields the loader reads; fp16 unless `dtype`), and
    `scheduler/scheduler_config.json` when given. -> bytes."""
    from safetensors.torch import save_file

    clip = pipe.text_encoder.config
    parts = {"unet": (pipe.unet, {"attention_head_dim": pipe.unet.config.attention_head_dim,
                                  "resnet_group_size": pipe.unet.config.resnet_group_size}),
             "text_encoder": (pipe.text_encoder, {
                 "vocab_size": clip.vocab_size, "hidden_size": clip.hidden_size,
                 "num_hidden_layers": clip.num_layers, "num_attention_heads": clip.num_heads,
                 "hidden_act": clip.hidden_act}),
             "vae": (pipe.vae, {"scaling_factor": pipe.vae.config.scaling_factor})}
    nbytes = 0
    for sub, (module, config) in parts.items():
        (repo / sub).mkdir(parents=True, exist_ok=True)
        state = {k: v.detach().to("cpu", dtype or torch.float16).contiguous()
                 for k, v in module.state_dict().items()}
        path = repo / sub / ("model.safetensors" if sub == "text_encoder"
                             else "diffusion_pytorch_model.safetensors")
        save_file(state, str(path))
        (repo / sub / "config.json").write_text(json.dumps(config))
        nbytes += path.stat().st_size
    if scheduler is not None:
        (repo / "scheduler").mkdir(parents=True, exist_ok=True)
        (repo / "scheduler" / "scheduler_config.json").write_text(json.dumps(scheduler))
    return nbytes


def write_checker(model_dir: Path, config, seed: int, device) -> int:
    """A safety checker of `config` with seeded weights (the concept and
    special-care embeddings N(0, 1), thresholds 0.5) as fp16 safetensors in
    the published layout, `position_ids` included, under `model_dir`.
    -> bytes."""
    from safetensors.torch import save_file

    from chiaswarm_tpu_torch.models.safety import SafetyChecker
    from chiaswarm_tpu_torch.pipelines.safety import init_random_

    with torch.device("meta"):
        model = SafetyChecker(config)
    model = model.to_empty(device=device).float()
    init_random_(model, torch.Generator(device=device).manual_seed(seed))
    state = {k: v.detach().to("cpu", torch.float16).contiguous()
             for k, v in model.state_dict().items()}
    positions = (config.image_size // config.patch_size) ** 2 + 1
    state["vision_model.vision_model.embeddings.position_ids"] = torch.arange(positions)[None]
    del model
    model_dir.mkdir(parents=True, exist_ok=True)
    path = model_dir / "model.safetensors"
    save_file(state, str(path))
    return path.stat().st_size


# the sd-x2-latent-upscaler's scheduler config as published
UPSCALER_SCHEDULER = {"_class_name": "EulerDiscreteScheduler", "beta_end": 0.012,
                      "beta_schedule": "scaled_linear", "beta_start": 0.00085,
                      "num_train_timesteps": 1000, "prediction_type": "sample",
                      "steps_offset": 1}


def serve_upscale_path(smi: str, xl_launches: dict, device: str = "cuda", sdxl: str = SDXL,
                       sd15: str = SD15, size_xl: int = SIZE, size15: int = 512,
                       steps: int = STEPS, up_steps: int = UPSCALE_STEPS, hold: bool = True,
                       seed_upscaler: str = UPSCALER, checker: str = CHECKER,
                       fillers=("test/tiny-sd", "test/tiny-xl")) -> tuple[dict, dict]:
    """Phase 5, the upscale and safety path: a registry of its own over a
    temporary root, where the SD-x2 upscaler (`seed_upscaler`'s
    pipeline on seeded weights, at the published widths unless a test name
    is given) is written under UPSCALER and the safety checker `checker`
    (ViT-L/14 unless a test name) from seeded tensors, both in their
    published layouts, and read back by the registry; SDXL and SD 1.5 on
    seeded random weights. The checker is called once directly (any
    exception fails the run), its concept scores through the kernels in
    bf16 against the plain path in f32. Then through the worker, each
    job's launches held to its UNet calls, its upscaler's K-UNet calls x
    K_UNET_LAUNCHES with one encode and one decode, and one checker call:
    SD 1.5 `size15`^2 txt2img plain and with `upscale` (2x out), SDXL
    `size_xl`^2 the same, a standalone StableDiffusionLatentUpscalePipeline
    job on a served `size15`^2 start image; every envelope must say
    `nsfw_checked: true` and none `latent-resize-fallback`. Then the
    upscaler's folder is removed, `fillers` evict it, and one more SD 1.5
    upscale job must be served 2x through the latent-resize fallback and
    say so. Before that, one bf16 K-UNet call through the kernels against
    f32 on the plain path (phase 7's bound), and torch.profiler over a
    checker call, a K-UNet call at both canvases and the upscaler's decode
    to `size_xl` and to twice it. `hold` false only prints the launches
    (the CPU rehearsal)."""
    import gc
    import shutil
    import tempfile

    import numpy as np

    from chiaswarm_tpu_torch.models.safety import TINY_SAFETY, SafetyConfig
    from chiaswarm_tpu_torch.pipelines.upscale import LatentUpscalePipeline
    from chiaswarm_tpu_torch.registry import Registry
    from chiaswarm_tpu_torch.weights import is_test_model

    on_card = torch.device(device).type == "cuda"
    pipeline_type = "StableDiffusionLatentUpscalePipeline"
    root = Path(tempfile.mkdtemp(prefix="chip-smoke-upscale-"))
    try:
        registry = Registry(torch.device(device), str(root), safety_checker_model=checker)
        t0 = time.perf_counter()
        pipes = {m: registry.get_pipeline(m, allow_random_init=True) for m in (sdxl, sd15)}
        log(f"[upscale] {sdxl} and {sd15} resident in a registry of their own in "
            f"{time.perf_counter() - t0:.1f}s")
        t0 = time.perf_counter()
        seeded = LatentUpscalePipeline(seed_upscaler, device=device, allow_random_init=True)
        files = {"upscaler_bytes": write_upscaler(seeded, root / UPSCALER, UPSCALER_SCHEDULER),
                 "upscaler_write_s": time.perf_counter() - t0}
        del seeded
        gc.collect()
        t0 = time.perf_counter()
        files["checker_bytes"] = write_checker(
            root / checker, TINY_SAFETY if is_test_model(checker) else SafetyConfig(), 71,
            device)
        files["checker_write_s"] = time.perf_counter() - t0
        upscaler = registry.get_pipeline(UPSCALER, pipeline_type=pipeline_type)
        check(upscaler.weights_source == "checkpoint",
              f"{UPSCALER}: weights {upscaler.weights_source}")
        files["upscaler_load"] = upscaler.checkpoint
        t0 = time.perf_counter()
        nsfw = registry.safety_checker()
        files["checker_load_s"] = time.perf_counter() - t0
        check(nsfw.available and nsfw.weights_source == "checkpoint",
              f"{checker} did not load from its checkpoint")
        log(f"[upscale] {UPSCALER} written in {files['upscaler_write_s']:.2f}s "
            f"({files['upscaler_bytes']} bytes of fp16 safetensors) and loaded in "
            f"{upscaler.checkpoint['load_s']:.2f}s (K-UNet widths "
            f"{upscaler.unet.config.block_out_channels}); {checker} written in "
            f"{files['checker_write_s']:.2f}s ({files['checker_bytes']} bytes), loaded in "
            f"{files['checker_load_s']:.2f}s; "
            f"{torch.cuda.memory_allocated() / 2**30 if on_card else 0:.1f} GiB allocated")

        # the checker called directly, outside flag_images (which swallows
        # every exception by design): it must run, on the card's kernels
        images = [start_image(size15), photo_image(size15)]
        scores, flags = nsfw.scores(images)
        served = {"files": files, "checker_direct": {"flags": flags,
                                                     "scores": scores.tolist()}}
        if on_card:
            served["checker_e2e"] = checker_bf16_check(nsfw, images)
        log(f"[upscale] the checker on two images: flags {flags}, concept scores "
            f"{np.round(scores, 4).tolist()}")

        common = {"negative_prompt": "blurry", "num_inference_steps": steps,
                  "guidance_scale": 7.0, "content_type": "image/png",
                  "prompt": "a lighthouse on a cliff at dusk"}

        def txt(job_id, model, size, seed, **params):
            return {**common, "id": job_id, "workflow": "txt2img", "model_name": model,
                    "height": size, "width": size, "seed": seed,
                    "parameters": {"scheduler_type": "DPMSolverMultistepScheduler", **params}}

        jobs = [
            ("up_sd15_plain", "txt2img", txt("up-sd15-plain", sd15, size15, 7000)),
            ("up_sd15", "txt2img", txt("up-sd15", sd15, size15, 7001, upscale=True)),
            ("up_sdxl_plain", "txt2img", txt("up-sdxl-plain", sdxl, size_xl, 7002)),
            ("up_sdxl", "txt2img", txt("up-sdxl", sdxl, size_xl, 7003, upscale=True)),
            ("up_standalone", "upscale", {
                **common, "id": "up-standalone", "workflow": "img2img", "model_name": UPSCALER,
                "height": size15, "width": size15, "seed": 7004, "start_image_uri": "photo",
                "num_inference_steps": up_steps, "parameters": {"pipeline_type": pipeline_type}}),
        ]
        per_call = {sd15: SD_UNET_LAUNCHES, sdxl: xl_launches}
        paths, got = serve_counted(smi, registry, jobs, per_call, device, tag="upscale",
                                   where="upscale path", hold=False,
                                   k_unet_per_call=K_UNET_LAUNCHES,
                                   checker_per_call=CHECKER_LAUNCHES)
        for job_id, job in got["jobs"].items():
            check(job["nsfw_checked"] is True, f"{job_id}: nsfw_checked {job['nsfw_checked']}")
            check(job["upscaler"] is None, f"{job_id}: upscaler {job['upscaler']}")
        check(got["jobs"]["up-sdxl"]["output_size"] == [2 * size_xl] * 2,
              f"up-sdxl: output_size {got['jobs']['up-sdxl']['output_size']}")

        # one K-UNet call, the checker and the decodes: numerics and time
        if on_card:
            served["e2e"] = k_unet_bf16_check(upscaler, size15)
        served["profile"] = profile_upscale(upscaler, nsfw, images, size15, size_xl, smi,
                                            on_card)

        # the weightless upscaler: its folder removed and the pipeline
        # evicted, a job falls back to the latent resize, and says so
        shutil.rmtree(root / UPSCALER)
        del upscaler
        for model in (sd15, sdxl, *fillers):
            registry.get_pipeline(model)
        check(UPSCALER not in registry.resident_models(),
              f"{UPSCALER} still resident: {registry.resident_models()}")
        fallback_paths, fallback = serve_counted(
            smi, registry, [("up_fallback", "txt2img", txt("up-fallback", sd15, size15, 7005,
                                                           upscale=True))],
            per_call, device, tag="upscale", where="upscale path", hold=False,
            k_unet_per_call=K_UNET_LAUNCHES, checker_per_call=CHECKER_LAUNCHES)
        job = fallback["jobs"]["up-fallback"]
        check(job["upscaler"] == "latent-resize-fallback" and job["output"] == 2 * size15,
              f"up-fallback: upscaler {job['upscaler']}, output {job['output']}")
        check(job["nsfw_checked"] is True, "up-fallback: not checked")
        paths.update(fallback_paths)
        got["jobs"].update(fallback["jobs"])
        got["fma_bf16"].update(fallback["fma_bf16"])
        if hold:
            hold_launches(got, "upscale path")
        else:
            for job_id, job in got["jobs"].items():
                log(f"[upscale] {job_id}: launches {job['launches']}, predicted "
                    f"{job['predicted_launches']} (not held)")
        served.update(got)
        del pipes, nsfw, registry
        gc.collect()
        return paths, served
    finally:
        shutil.rmtree(root, ignore_errors=True)


def k_unet_inputs(pipe, size: int, dtype=None, seed: int = 5):
    """(x, t, context, timestep condition) of one K-UNet call on the 2x
    latents of a `size`^2 job: 8 channels, the timestep of a mid sigma."""
    from chiaswarm_tpu_torch.pipelines.upscale import _timestep_condition

    dtype = dtype or pipe.dtype
    gen = torch.Generator(device=pipe.device).manual_seed(seed)
    cfg = pipe.unet.config
    side = 2 * size // pipe.latent_factor

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=pipe.device).to(dtype)

    x = randn(1, cfg.in_channels, side, side).contiguous(memory_format=torch.channels_last)
    cond = _timestep_condition(cfg.time_cond_proj_dim,
                               randn(1, pipe.text_encoder.config.hidden_size))
    return x, torch.full((1,), 0.5, device=pipe.device), randn(1, 77, cfg.cross_attention_dim), cond


def k_unet_bf16_check(pipe, size: int) -> dict:
    """One bf16 K-UNet call on the 2x latents of a `size`^2 job through the
    kernels, against the same weights in f32 on the plain path: the
    relative RMS error at most E2E_RATIO x the plain path's in bf16."""
    import copy

    x, t, ctx, cond = k_unet_inputs(pipe, size)
    with torch.inference_mode():
        kernels = pipe.unet(x, t, ctx, cond).float()
        with plain_path():
            plain = pipe.unet(x, t, ctx, cond).float()
            wide = copy.deepcopy(pipe.unet).float()
            exact = wide(x.float(), t, ctx.float(), cond.float())
            del wide
        torch.cuda.synchronize()
    scale = rms(exact)
    row = {"rel_rms_err": rms(kernels - exact) / scale,
           "plain_bf16_rel_rms_err": rms(plain - exact) / scale,
           "finite": bool(torch.isfinite(kernels).all())}
    log(f"[e2e] {pipe.model_name} K-UNet call on {2 * size // pipe.latent_factor}^2 latents, "
        f"bf16 through the kernels vs f32 plain path: relative RMS err "
        f"{row['rel_rms_err']:.4g}; plain path in bf16: {row['plain_bf16_rel_rms_err']:.4g} "
        f"(bound {E2E_RATIO}x that)")
    check(row["finite"], "K-UNet: non-finite output through the kernels")
    check(row["rel_rms_err"] <= E2E_RATIO * row["plain_bf16_rel_rms_err"],
          f"K-UNet: bf16 kernel path error {row['rel_rms_err']} > {E2E_RATIO} x the plain "
          f"bf16 path's {row['plain_bf16_rel_rms_err']}")
    return row


# the checker's concept scores through the kernels (bf16) against the
# plain path in f32: cosines less thresholds, each within this many
# units (the bf16 tower's embeddings carry about 2^-8 relative error)
SCORE_TOL = 0.02


def checker_bf16_check(checker, images) -> dict:
    """The checker's concept scores and its tower's embeddings in bf16
    through the kernels against the same weights in f32 on the plain path:
    the embeddings' relative RMS error at most E2E_RATIO x the plain
    path's in bf16, every score within SCORE_TOL, and the same flags
    wherever a score is farther than SCORE_TOL from its threshold."""
    import copy

    from chiaswarm_tpu_torch.models.safety import CLIPVisionEncoder

    px = checker.pixels(images)
    model = checker.model
    with torch.inference_mode():
        kernels = model(px)
        embed = CLIPVisionEncoder.forward(model, px).float()
        with plain_path():
            plain = CLIPVisionEncoder.forward(model, px).float()
            wide = copy.deepcopy(model).float()
            exact_scores = wide(px.float())
            exact = CLIPVisionEncoder.forward(wide, px.float())
            del wide
        torch.cuda.synchronize()
    scale = rms(exact)
    err = (kernels[0] - exact_scores[0]).abs().max().item()
    sure = (exact_scores[0].abs() > SCORE_TOL).all(dim=-1)
    row = {"embed_rel_rms_err": rms(embed - exact) / scale,
           "plain_bf16_embed_rel_rms_err": rms(plain - exact) / scale,
           "score_max_abs_err": err,
           "flags": kernels[1].tolist(), "f32_flags": exact_scores[1].tolist()}
    log(f"[e2e] safety checker on {len(images)} images, bf16 through the kernels vs f32 "
        f"plain path: embeddings relative RMS err {row['embed_rel_rms_err']:.4g} (plain bf16 "
        f"{row['plain_bf16_embed_rel_rms_err']:.4g}, bound {E2E_RATIO}x that); concept scores "
        f"max abs err {err:.4g} (bound {SCORE_TOL}); flags {row['flags']} (f32 "
        f"{row['f32_flags']})")
    check(row["embed_rel_rms_err"] <= E2E_RATIO * row["plain_bf16_embed_rel_rms_err"],
          f"checker embeddings: bf16 kernel path error {row['embed_rel_rms_err']} > {E2E_RATIO}"
          f" x the plain bf16 path's {row['plain_bf16_embed_rel_rms_err']}")
    check(err <= SCORE_TOL, f"checker concept scores off by {err} > {SCORE_TOL}")
    check(bool((kernels[1] == exact_scores[1])[sure].all()),
          f"checker flags {row['flags']} against f32 {row['f32_flags']}")
    return row


def profile_upscale(upscaler, checker, images, size15: int, size_xl: int, smi: str,
                    on_card: bool) -> dict:
    """Phase 8 for the upscale path: one checker call (per image), a few
    K-UNet calls on the 2x latents of a `size15`^2 and a `size_xl`^2 job,
    and the upscaler VAE's decode to `size_xl`^2 and to twice it."""
    px = checker.pixels(images[:1])
    # part: (fn, calls, canvas, model)
    fns = {"checker": (lambda: checker.model(px), 3, checker.config.image_size,
                       checker.model_name)}
    for size in (size15, size_xl):
        x, t, ctx, cond = k_unet_inputs(upscaler, size)
        fns[f"k_unet_{2 * size}"] = (lambda x=x, t=t, ctx=ctx, cond=cond:
                                     upscaler.unet(x, t, ctx, cond), 3, 2 * size,
                                     upscaler.model_name)
    for out in (size_xl, 2 * size_xl):
        z = torch.randn((1, upscaler.latent_channels, out // upscaler.latent_factor,
                         out // upscaler.latent_factor), device=upscaler.device,
                        generator=torch.Generator(device=upscaler.device).manual_seed(3))
        z = z.to(upscaler.dtype).contiguous(memory_format=torch.channels_last)
        fns[f"vae_decode_{out}"] = (lambda z=z: upscaler.vae.decode(z), 1, out,
                                    upscaler.model_name)
    profile = {}
    for name, (fn, calls, canvas, model) in fns.items():
        profile.update(profile_fns(model, canvas, 1, {name: (fn, calls)}, upscaler.device))
    log_profile(profile, smi)
    if on_card:
        check_one_launch_per_call(profile)
    return profile


# --- phase 6 ---

# --- Flux ---

def write_flux(pipe, model_dir: Path, dtype=None) -> int:
    """A FluxPipeline's weights in the diffusers layout the JAX package's
    `_convert_params` reads: transformer/, text_encoder_2/ (T5),
    text_encoder/ (CLIP-L), vae/, one safetensors file each (in `dtype`,
    the pipeline's unset). -> bytes written."""
    from safetensors.torch import save_file

    from chiaswarm_tpu_torch.weights import FLUX_FOLDERS

    nbytes = 0
    for folder, module in zip(FLUX_FOLDERS, (pipe.transformer, pipe.t5, pipe.clip, pipe.vae)):
        (model_dir / folder).mkdir(parents=True, exist_ok=True)
        path = model_dir / folder / "model.safetensors"
        save_file({k: v.detach().to("cpu", dtype or v.dtype).contiguous()
                   for k, v in module.state_dict().items()}, str(path))
        nbytes += path.stat().st_size
    return nbytes


def tiny_flux_checks(device: str = "cuda", size: int = 64, steps: int = 4) -> dict:
    """Phase 4 for Flux: test/tiny-flux and test/tiny-flux-schnell, seeded,
    written as safetensors under a temporary model root and loaded from
    there in f32 on `device` (the kernels on the card) and on the CPU
    (plain versions): one job of two images and one coalesced pass of two
    requests with the same injected latents on both, the uint8 images
    within 2/255. -> {model: max pixel diffs}."""
    import tempfile

    import numpy as np

    from chiaswarm_tpu_torch.pipelines.flux import FluxPipeline

    result = {}
    with tempfile.TemporaryDirectory() as root:
        for model in ("test/tiny-flux", "test/tiny-flux-schnell"):
            write_flux(FluxPipeline(model, device="cpu"), Path(root) / model)
            cpu = FluxPipeline(model, device="cpu", model_root_dir=root)
            card = FluxPipeline(model, device=device, dtype=torch.float32, model_root_dir=root)
            check(cpu.weights_source == card.weights_source == "checkpoint",
                  f"{model}: weights {cpu.weights_source}, {card.weights_source}")
            lat = size // cpu.latent_factor
            latents = torch.randn((2, lat, lat, cpu.latent_channels),
                                  generator=torch.Generator().manual_seed(8))
            kw = dict(num_inference_steps=steps, height=size, width=size,
                      num_images_per_prompt=2, latents=latents)
            want, _ = cpu.run("a red cube", **kw)
            got, config = card.run("a red cube", **kw)
            diff = max(int(np.abs(g.astype(np.int16) - w.astype(np.int16)).max())
                       for g, w in zip(got, want))
            requests = [{"prompt": "a red cube", "seed": 1}, {"prompt": "a blue sphere",
                                                              "seed": 2}]
            # the same draw on both (a CUDA generator draws other numbers)
            kw = dict(num_inference_steps=steps, height=size, width=size, guidance_scale=3.5,
                      latents=torch.randn((2, lat, lat, cpu.latent_channels),
                                          generator=torch.Generator().manual_seed(9)))
            want = cpu.run_batched(requests, **kw)
            got = card.run_batched(requests, **kw)
            batched = max(int(np.abs(g[0][0].astype(np.int16) - w[0][0].astype(np.int16)).max())
                          for g, w in zip(got, want))
            log(f"[tiny] {model} {size}^2 f32 ({config['steps']} steps, weights "
                f"{config['weights']}), card (kernels) vs CPU (plain): max pixel diff {diff}/255, "
                f"coalesced pass of two {batched}/255 (bound 2/255)")
            check(diff <= 2 and batched <= 2, f"{model} card vs CPU pixel diff {diff}, "
                  f"{batched} > 2")
            result[model] = {"diff": diff, "batched_diff": batched}
    return result


def flux_inputs(pipe, size: int = SIZE, rows: int = 1, seed: int = 6, dtype=None):
    """(img, img_ids, txt, txt_ids, t, pooled, guidance) for one Flux
    transformer call at size^2 with 512 T5 tokens: random patchified
    latents, context and pooled vector, flow time 0.5, guidance 3.5."""
    from chiaswarm_tpu_torch.models.flux import patchify

    cfg, dev = pipe.transformer.config, pipe.device
    dtype = dtype or pipe.dtype
    gen = torch.Generator(device=dev).manual_seed(seed)
    lat = size // pipe.latent_factor
    latents = torch.randn((rows, lat, lat, pipe.latent_channels), generator=gen, device=dev)
    img, img_ids = patchify(latents.to(dtype))
    txt = torch.randn((rows, 512, cfg.context_dim), generator=gen, device=dev).to(dtype)
    pooled = torch.randn((rows, cfg.pooled_dim), generator=gen, device=dev).to(dtype)
    txt_ids = torch.zeros((rows, 512, 3), dtype=torch.int32, device=dev)
    t = torch.full((rows,), 0.5, device=dev)
    return img, img_ids, txt, txt_ids, t, pooled, torch.full((rows,), 3.5, device=dev)


class _F32Block(torch.nn.Module):
    """A transformer block run in f32 on a copy made for the one call and
    dropped after it: the f32 reference of a full-width transformer holds
    one block's f32 weights at a time."""

    def __init__(self, block):
        super().__init__()
        self.block = [block]  # not a submodule: the shell's .float() must not copy it

    def forward(self, *args):
        import copy

        wide = copy.deepcopy(self.block[0]).float()
        out = wide(*args)
        del wide
        return out


def flux_f32_reference(transformer):
    """The transformer's f32 twin for a plain-path reference: its small
    top-level modules copied to f32, its blocks run through `_F32Block`."""
    import dataclasses

    from chiaswarm_tpu_torch.models.flux import FluxTransformer

    cfg = dataclasses.replace(transformer.config, depth_double=0, depth_single=0)
    with torch.device("meta"):
        shell = FluxTransformer(cfg)
    shell = shell.to_empty(device=transformer.x_embedder.weight.device).eval()
    top = {k: v for k, v in transformer.state_dict().items() if "transformer_blocks." not in k}
    shell.load_state_dict(top)
    shell.config = transformer.config
    shell.transformer_blocks = torch.nn.ModuleList(
        [_F32Block(b) for b in transformer.transformer_blocks])
    shell.single_transformer_blocks = torch.nn.ModuleList(
        [_F32Block(b) for b in transformer.single_transformer_blocks])
    return shell


def flux_bf16_check(pipe, size: int = SIZE) -> dict:
    """Phase 7 for Flux: one full-width transformer call at size^2 in bf16
    through the kernels against the same weights in f32 on the plain path,
    block by block (each block's f32 copy made in turn: an f32 copy of the
    whole transformer, 47.6 GB, does not fit beside the bf16 bundle); the
    plain path in bf16 gives the error bf16 itself makes. The relative RMS
    error may be at most E2E_RATIO x that."""
    from chiaswarm_tpu_torch.device import synchronize

    check(pipe.dtype == torch.bfloat16, f"the Flux path runs {pipe.dtype}, not bf16")
    inputs = flux_inputs(pipe, size)
    with torch.inference_mode():
        kernels = pipe.transformer(*inputs).float()
        with plain_path():
            plain = pipe.transformer(*inputs).float()
            shell = flux_f32_reference(pipe.transformer)
            wide_inputs = [x.float() if x.is_floating_point() else x for x in inputs]
            exact = shell(*wide_inputs).float()
            del shell
        synchronize(pipe.device)
    scale = rms(exact)
    row = {"rel_rms_err": rms(kernels - exact) / scale,
           "plain_bf16_rel_rms_err": rms(plain - exact) / scale,
           "finite": bool(torch.isfinite(kernels).all()), "output_rms": scale}
    del kernels, plain, exact
    torch.cuda.empty_cache()
    log(f"[e2e] {pipe.model_name} transformer at {size}^2 (1 row, 512 T5 tokens), bf16 through "
        f"the kernels vs f32 plain path (block by block): relative RMS err "
        f"{row['rel_rms_err']:.4g}; plain path in bf16: {row['plain_bf16_rel_rms_err']:.4g} "
        f"(bound {E2E_RATIO}x that); f32 output RMS {scale:.4g}")
    check(row["finite"], "flux transformer: non-finite output through the kernels")
    check(row["rel_rms_err"] <= E2E_RATIO * row["plain_bf16_rel_rms_err"],
          f"flux transformer: bf16 kernel path error {row['rel_rms_err']} > {E2E_RATIO} x the "
          f"plain bf16 path's {row['plain_bf16_rel_rms_err']}")
    return row


def flux_job(job_id: str, model: str, steps: int, seed: int, size: int = SIZE,
             guidance: float = 3.5, prompt: str = "a lighthouse on a cliff at dusk",
             max_sequence_length: int | None = 512) -> dict:
    """A FluxPipeline txt2img job as the hive sends it; without
    `max_sequence_length` in its parameters the job may coalesce."""
    params = {"pipeline_type": "FluxPipeline"}
    if max_sequence_length is not None:
        params["max_sequence_length"] = max_sequence_length
    return {"id": job_id, "workflow": "txt2img", "model_name": model,
            "prompt": f"{prompt}, study {seed}", "height": size, "width": size,
            "num_inference_steps": steps, "guidance_scale": guidance, "seed": seed,
            "content_type": "image/png", "parameters": params}


def check_flux_envelopes(jobs: list, results: dict, launches: dict, size: int,
                         coalesced: bool, hold: bool, smi: str, per_call: dict) -> dict:
    """Every envelope of a served Flux group (sha256, a decodable image
    that is not constant, finite latents, txt2img on the flow-matching
    solver at the job's steps and guidance; `batched_with` / `batch_rows`
    / `padded_rows` for a pass), and its launches held to the prediction:
    `per_call`, a transformer call's launches (one joint attention in each
    block, 57 at full depth; no GroupNorm), and one VAE decode an image
    (one attention, 30 GroupNorm). -> {"jobs": {id: ...},
    "launches", "predicted", "job_s", "images_per_s"}."""
    import numpy as np

    from chiaswarm_tpu_torch.pipelines.common import pad_bucket

    out = {"jobs": {}}
    for offset, job in enumerate(jobs):
        r = results[job["id"]]
        cfg = r["pipeline_config"]
        check(not r.get("fatal_error") and "error" not in cfg, f"{job['id']}: {cfg}")
        image = decode_artifact(r["artifacts"]["primary"])
        check(image.shape == (size, size, 3), f"{job['id']}: image {image.shape}")
        check(int(image.max()) != int(image.min()), f"{job['id']}: constant image")
        check(cfg["latents"]["finite"], f"{job['id']}: non-finite latents")
        check(cfg["mode"] == "txt2img" and cfg["scheduler"] == "FlowMatchEulerScheduler"
              and cfg["steps"] == job["num_inference_steps"]
              and cfg["guidance_scale"] == job["guidance_scale"] and cfg["model"] == job[
                  "model_name"] and cfg["pipeline"] == "FluxPipeline",
              f"{job['id']}: envelope {cfg}")
        if coalesced:
            check(cfg.get("batched_with") == len(jobs) and cfg["batch_rows"] == [offset, 1]
                  and cfg["padded_rows"] == pad_bucket(len(jobs)),
                  f"{job['id']}: batched_with {cfg.get('batched_with')}, batch_rows "
                  f"{cfg.get('batch_rows')}, padded_rows {cfg.get('padded_rows')}")
        else:
            check("batched_with" not in cfg, f"{job['id']} alone: {cfg.get('batched_with')}")
        t = cfg["timings"]
        out["jobs"][job["id"]] = {"timings": t, "latents": cfg["latents"],
                                  "pixels_sha256": hashlib.sha256(image.tobytes()).hexdigest(),
                                  "image": image}
        log(f"[flux] {job['id']} ({cfg['model']}, {size}^2, {cfg['steps']} steps, guidance "
            f"{cfg['guidance_scale']}, max_sequence_length {cfg['max_sequence_length']}"
            + (f", pass of {cfg['batched_with']}" if coalesced else "") + f") on {smi}: job "
            f"{t['job_s']:.3f}s = text_encode {t['text_encode_s']:.3f}s + denoise "
            f"{t['denoise_s']:.3f}s (transformer step {t['transformer_step_ms']:.1f} ms) + decode "
            f"{t['decode_s']:.3f}s + artifacts {t['encode_artifacts_s']:.3f}s; latents |max| "
            f"{cfg['latents']['absmax']:.3g}; pixels {int(image.min())}..{int(image.max())} mean "
            f"{float(image.mean()):.1f}")
    steps = jobs[0]["num_inference_steps"]
    images = len(jobs)
    calls = 1 if coalesced else images
    predicted = {k: calls * steps * per_call[k] + images * DECODE_LAUNCHES[k]
                 for k in per_call}
    counted = {k: v[0] for k, v in launches.items()}
    log(f"[flux] kernel launches: counted {json.dumps(counted)}, predicted "
        f"{json.dumps(predicted)} ({calls} x {steps} transformer calls x "
        f"{json.dumps(per_call)} + {images} decodes)")
    if hold:
        check(counted == predicted, f"flux: launches {counted} != predicted {predicted}")
        for name, count in counted.items():
            check(count > 0, f"{name} was never launched on the Flux path")
    configs = [results[j["id"]]["pipeline_config"] for j in jobs]
    job_s = configs[0]["timings"]["job_s"] if coalesced else sum(
        c["timings"]["job_s"] for c in configs)
    out.update(launches=counted, predicted=predicted, job_s=job_s,
               images_per_s=images / job_s,
               step_ms=float(np.mean([c["timings"]["transformer_step_ms"] for c in configs])))
    return out


def _allocated_gib(device: str) -> float:
    return torch.cuda.memory_allocated() / 2**30 if device == "cuda" else 0.0


def _flux_joins(smi: str, registry, model: str, job_id: str, seed: int, device: str,
                size: int, steps: int, hold: bool) -> dict:
    """`model` built into `registry` beside what it holds, and one
    `steps`-step job served through the worker (launches held), with the
    allocated and free bytes, the bundle's need (capacity.resident_bytes)
    and the resident models before and after printed -> its row."""
    from chiaswarm_tpu_torch.capacity import free_bytes, resident_bytes

    before = registry.resident_models()
    row = {"allocated_gib_before": _allocated_gib(device), "resident_before": before,
           "free_gib_before": free_bytes(device) / 2**30 if device == "cuda" else 0.0,
           "need_gib": resident_bytes(device, model) / 2**30}
    t0 = time.perf_counter()
    pipe = registry.get_pipeline(model, allow_random_init=True, pipeline_type="FluxPipeline")
    row["build_s"] = time.perf_counter() - t0
    row["bundle_gib"] = sum(p.numel() * p.element_size() for m in (
        pipe.transformer, pipe.t5, pipe.clip, pipe.vae) for p in m.parameters()) / 2**30
    # one joint attention in each block, no GroupNorm
    per_call = {"flash_attention": pipe.config.depth_double + pipe.config.depth_single,
                "group_norm": 0}
    del pipe
    row["allocated_gib_built"] = _allocated_gib(device)
    job = flux_job(job_id, model, steps, seed, size, guidance=0.0 if "schnell" in model else 3.5,
                   max_sequence_length=256)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    results, launches, wall = serve_group(registry, [job], device, max_coalesce=1)
    row.update(check_flux_envelopes([job], results, launches, size, False, hold, smi, per_call))
    row["jobs"][job_id].pop("image")
    after = registry.resident_models()
    row.update(wall_s=wall, resident_after=after, evicted=sorted(set(before) - set(after)),
               allocated_gib_after=_allocated_gib(device),
               peak_gib=torch.cuda.max_memory_allocated() / 2**30 if device == "cuda" else 0.0)
    log(f"[flux] {model} joins {len(before)} resident pipelines ({', '.join(before)}): "
        f"{row['allocated_gib_before']:.2f} GiB allocated and {row['free_gib_before']:.2f} GiB "
        f"free before, {row['need_gib']:.2f} GiB needed; its {row['bundle_gib']:.2f} GiB bundle "
        f"built in {row['build_s']:.1f}s ({row['allocated_gib_built']:.2f} GiB allocated), "
        f"evicted {row['evicted']}; one {steps}-step job in {wall:.1f}s, peak "
        f"{row['peak_gib']:.2f} GiB; {row['allocated_gib_after']:.2f} GiB allocated after, "
        f"resident {after}")
    check(model in after, f"{model} is not resident after its job: {after}")
    return row


def serve_flux_beside_sd(smi: str, registry, device: str = "cuda", sdxl: str = SDXL,
                         schnell: str = FLUX_SCHNELL, dev: str = FLUX_DEV, size: int = SIZE,
                         steps: int = FLUX_SCHNELL_STEPS, hold: bool = True) -> dict:
    """Flux joining the main path's registry while its SDXL pipelines, the
    SD registry, the detectors and the checker are still resident, as in
    a worker that serves both families. First FLUX.1-schnell, one
    `steps`-step job: the SDXL base, the most recently used, must stay.
    Then FLUX.1-dev, one `steps`-step job: the two Flux bundles and the
    SDXL pipelines do not fit together, and on the card the free memory
    before its build must be less than its bundle, so the build succeeds
    only because the registry evicts by bytes first (`Registry._make_room`;
    a count eviction comes after a build). -> {"schnell": row, "dev":
    row}."""
    served = {"schnell": _flux_joins(smi, registry, schnell, "flux-beside-sdxl", 4300, device,
                                     size, steps, hold)}
    check(sdxl in served["schnell"]["resident_after"],
          f"{sdxl} was evicted for {schnell}: {served['schnell']['resident_after']}")
    served["dev"] = _flux_joins(smi, registry, dev, "flux-dev-joins", 4301, device, size,
                                steps, hold)
    if device == "cuda":
        row = served["dev"]
        check(row["free_gib_before"] < row["bundle_gib"] and row["evicted"],
              f"{dev}: {row['free_gib_before']:.2f} GiB free before its "
              f"{row['bundle_gib']:.2f} GiB bundle, evicted {row['evicted']}: the step did not "
              "exercise the eviction by bytes")
    return served


def serve_flux_path(smi: str, device: str = "cuda", dev: str = FLUX_DEV,
                    schnell: str = FLUX_SCHNELL, size: int = SIZE,
                    dev_steps: int = FLUX_DEV_STEPS, schnell_steps: int = FLUX_SCHNELL_STEPS,
                    hold: bool = True) -> tuple[dict, dict]:
    """Phase 5, the Flux path, in a registry of its own (nothing else may
    be resident: the caller releases the earlier paths' models first):
    FLUX.1-dev's full bundle on seeded random weights; two 1024^2 28-step
    jobs through the worker, one at a time; one coalesced pass of four
    jobs with explicit steps and guidance, queued before the worker's
    first poll; the same four jobs' first, served alone, beside it; then
    one full-width transformer call held to f32 on the plain path
    (`flux_bf16_check`) and profiled; then dev released and
    FLUX.1-schnell's bundle built for one 4-step job. Resident and peak
    bytes are printed. -> ({job kind: (jobs, {kernel: (launches, {shape:
    launches})})}, served)."""
    import gc

    import numpy as np

    from chiaswarm_tpu_torch.registry import Registry

    served = {"allocated_gib_before": _allocated_gib(device)}
    paths = {}
    registry = Registry(torch.device(device), str(ROOT / ".no-models"))
    t0 = time.perf_counter()
    pipe = registry.get_pipeline(dev, allow_random_init=True, pipeline_type="FluxPipeline")
    served["dev_resident_s"] = time.perf_counter() - t0
    served["dev_resident_gib"] = _allocated_gib(device)
    log(f"[flux] {dev} resident in {served['dev_resident_s']:.1f}s (seeded random weights, "
        f"{pipe.dtype}, {sum(p.numel() for p in pipe.transformer.parameters()) / 1e9:.2f} B "
        f"transformer and {sum(p.numel() for p in pipe.t5.parameters()) / 1e9:.2f} B T5 "
        f"parameters): {served['allocated_gib_before']:.2f} GiB allocated before, "
        f"{served['dev_resident_gib']:.2f} GiB after")

    def run_group(name, jobs, coalesced, polls=None):
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        results, launches, wall = serve_group(registry, jobs, device,
                                              max_coalesce=8 if coalesced else 1, polls=polls)
        # one joint attention in each block, no GroupNorm
        cfg = registry.get_pipeline(jobs[0]["model_name"], pipeline_type="FluxPipeline").config
        per_call = {"flash_attention": cfg.depth_double + cfg.depth_single, "group_norm": 0}
        row = check_flux_envelopes(jobs, results, launches, size, coalesced, hold, smi,
                                   per_call)
        row["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30 if device == "cuda" else 0.0
        row["wall_s"] = wall
        log(f"[flux] {name}: {len(jobs)} jobs in {wall:.1f}s served, {row['images_per_s']:.4f} "
            f"images/s by job_s, transformer step {row['step_ms']:.1f} ms; peak "
            f"{row['peak_gib']:.2f} GiB allocated")
        paths[name] = (len(jobs) if not coalesced else 1, launches)
        served[name] = row
        return row

    solo, polls = [], []
    for i in range(2):
        solo.append(run_group(f"flux_dev_{i}", [flux_job(f"flux-dev-{i}", dev, dev_steps,
                                                         4000 + i, size)], False, polls))
    advertised = {k: polls[0].get(k) for k in ("flux_runnable", "unconverted_families")}
    log(f"[flux] the worker's first poll advertises {json.dumps(advertised)}")
    check(int(advertised["flux_runnable"] or 0) == 1
          and "flux" not in str(advertised["unconverted_families"]).split(","),
          f"the poll advertises {advertised}, not flux_runnable 1 without flux unconverted")
    served["advertised"] = advertised
    pass_jobs = [flux_job(f"flux-pass-{i}", dev, dev_steps, 4100 + i, size,
                          max_sequence_length=None) for i in range(4)]
    from chiaswarm_tpu_torch.coalesce import coalesce_key

    check(len({coalesce_key(j) for j in pass_jobs}) == 1 and coalesce_key(pass_jobs[0]),
          "the Flux pass's jobs do not share one coalesce key")
    coalesced = run_group("flux_dev_pass", pass_jobs, True)
    twin = run_group("flux_dev_pass_twin", [dict(pass_jobs[0], id="flux-pass-twin")], False)
    diff = int(np.abs(coalesced["jobs"]["flux-pass-0"]["image"].astype(np.int16)
                      - twin["jobs"]["flux-pass-twin"]["image"].astype(np.int16)).max())
    alone_rate = 1.0 / float(np.mean([r["job_s"] for r in (*solo, twin)]))
    served["pass_vs_alone"] = {"pass_images_per_s": coalesced["images_per_s"],
                               "alone_images_per_s": alone_rate,
                               "first_row_vs_alone_max_pixel_diff": diff}
    log(f"[flux] coalesced pass of 4: {coalesced['images_per_s']:.4f} images/s against "
        f"{alone_rate:.4f} alone ({coalesced['images_per_s'] / alone_rate:.2f}x); its first "
        f"row against the same job alone: max pixel diff {diff}/255 (bf16 at another batch "
        "width; not held)")
    for row in served.values():
        if isinstance(row, dict):
            for job in row.get("jobs", {}).values():
                job.pop("image", None)
    if device == "cuda":
        served["e2e"] = flux_bf16_check(pipe, size)
        inputs = flux_inputs(pipe, size)
        served["profile"] = profile_fns(dev, size, 1, {
            "transformer": (lambda: pipe.transformer(*inputs), 2)}, pipe.device)
        log_profile(served["profile"], smi)
        check_one_launch_per_call(served["profile"])
        del inputs
    del pipe
    registry = None
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    served["dev_released_gib"] = _allocated_gib(device)
    registry = Registry(torch.device(device), str(ROOT / ".no-models"))
    t0 = time.perf_counter()
    registry.get_pipeline(schnell, allow_random_init=True, pipeline_type="FluxPipeline")
    log(f"[flux] {dev} released: {served['dev_released_gib']:.2f} GiB allocated; {schnell} "
        f"resident in {time.perf_counter() - t0:.1f}s: {_allocated_gib(device):.2f} GiB")
    run_group("flux_schnell", [flux_job("flux-schnell-0", schnell, schnell_steps, 4200, size,
                                        guidance=0.0, max_sequence_length=256)], False)
    registry = None
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    served["allocated_gib_after"] = _allocated_gib(device)
    log(f"[flux] path done: {served['allocated_gib_after']:.2f} GiB allocated after")
    return paths, served


# the resume and cancel path: chunks of RESUME_CHUNK steps, a checkpoint
# every RESUME_CKPT_EVERY boundaries, a preview at every one
RESUME_CHUNK = 5
RESUME_CKPT_EVERY = 2


def _pixels(result: dict):
    return decode_artifact(result["artifacts"]["primary"])


def serve_resume_path(smi: str, registry, sd_registry, xl_launches: dict,
                      device: str = "cuda", sdxl: str = SDXL, sd15: str = SD15,
                      size_xl: int = SIZE, size15: int = 512, steps: int = STEPS,
                      batched_steps: int = BATCHED_STEPS, chunk: int = RESUME_CHUNK,
                      group_size: int = 4, heartbeat_seconds: float = HEARTBEAT_SECONDS,
                      hold: bool = True) -> tuple[dict, dict]:
    """Phase 5, the resume and cancel path, through the worker and the fake
    hive, in the main path's registries (`sdxl` in `registry`, `sd15` in
    `sd_registry`), every job DPM++ 2M unless said:

    1. an SDXL job served with chunking off, the same job (seed and prompt)
       chunked with nothing armed, then on a worker with chunks of `chunk`
       steps, a checkpoint
       every RESUME_CKPT_EVERY boundaries and a preview at every one: the
       same image bit for bit, checkpoints at steps 10 and 20 and previews
       at 5, 10, 15, 20 and 25 (each a decodable JPEG of the canvas);
    2. the job redelivered with the hive's step-20 offer to a second such
       worker, which advertises `resume_capable`: the same image, `resumed`
       {from_step 20, recomputed_steps 10}; then redelivered with the same
       checkpoint packed under a wrong program signature: the full pass,
       the same image;
    3. SD 1.5 under Euler ancestral, undisturbed, armed, and resumed at step
       20: the same image three times (the generator's state travels);
    4. an SDXL job cancelled by the hive after its first preview: no
       envelope, the device free within one chunk of the cancel reaching
       the worker, and the next job served;
    5. `group_size` SDXL jobs as one coalesced chunked pass at
       `batched_steps`, then the same jobs with one cancelled during the pass
       (an envelope for each other job, its image that of the same job in
       the first pass bit for bit), then with all of them cancelled (no
       envelope, the pass aborted).

    Each job's launches are held to its UNet calls x the per-call launches
    plus one decode and one decode a preview. -> ({job kind: (1, {kernel:
    (launches, {shape: launches})})}, served)."""
    from chiaswarm_tpu_torch.fake_hive import FakeHive
    from chiaswarm_tpu_torch.ops.flash_attention import COUNTER as FA_COUNTER
    from chiaswarm_tpu_torch.ops.group_norm import COUNTER as GN_COUNTER
    from chiaswarm_tpu_torch.settings import Settings
    from chiaswarm_tpu_torch.worker import Worker
    from PIL import Image

    counters = {"flash_attention": FA_COUNTER, "group_norm": GN_COUNTER}
    per_call = {sdxl: xl_launches, sd15: SD_UNET_LAUNCHES}
    hive = FakeHive(token="smoke-token")
    # job kind -> its launches, and the previews its serve received
    paths, previews_in, served = {}, {}, {"jobs": {}}

    def worker(reg, chunk: int = 0, ckpt: int = 0, preview: int = 0, coalesce: int = 1):
        settings = Settings(sdaas_token="smoke-token", sdaas_uri=hive.uri,
                            worker_name=f"chip-smoke-{chunk}-{ckpt}-{preview}-{coalesce}",
                            model_root_dir=reg.model_root_dir, max_coalesce=coalesce,
                            denoise_chunk_steps=chunk, checkpoint_every_chunks=ckpt,
                            preview_every_chunks=preview)
        return Worker(settings=settings, device=device, registry=reg, poll_seconds=0.05,
                      heartbeat_seconds=heartbeat_seconds)

    def job(job_id: str, model: str, size: int, seed: int, n_steps: int = steps,
            scheduler: str = "DPMSolverMultistepScheduler", prompt: str | None = None):
        return {"id": job_id, "workflow": "txt2img", "model_name": model,
                "prompt": prompt or "a lighthouse on a cliff at dusk, resumed",
                "negative_prompt": "blurry", "height": size, "width": size,
                "num_inference_steps": n_steps, "guidance_scale": 7.0, "seed": seed,
                "content_type": "image/png", "parameters": {"scheduler_type": scheduler}}

    def serve(w, jobs: list, kind: str | None = None, redeliver: bool = False, **hooks):
        """Queue `jobs` (as redeliveries, which carry the hive's resume
        offer) and serve them -> the new envelopes by id; the launches of a
        single job go to paths[kind]."""
        for j in jobs:
            if redeliver:
                hive.redeliver(j)
            else:
                hive.enqueue(j)
        for job_id, polls in hooks.get("on_heartbeat", {}).items():
            hive.cancel_on_heartbeat(job_id, polls)
        for job_id in hooks.get("after_partial", ()):
            hive.cancel_after_first_partial(job_id)
        before, seen, parts = _snapshot(counters), len(hive.results), len(hive.partials)
        asyncio.run(w.run(max_jobs=w.jobs_done + len(jobs)))
        after = _snapshot(counters)
        if kind is not None:
            paths[kind] = (1, {name: (after[name][0] - before[name][0],
                                      after[name][1] - before[name][1]) for name in counters})
            previews_in[kind] = sum(p["kind"] == "preview" for p in hive.partials[parts:])
        return {r["id"]: r for r in hive.results[seen:]}

    def hold_job(kind: str, result: dict, model: str, unet_calls: int):
        previews = previews_in[kind]
        counted = {name: launches for name, (launches, _) in paths[kind][1].items()}
        cfg = result["pipeline_config"]
        predicted = {name: unet_calls * per_call[model][name]
                     + (1 + previews) * DECODE_LAUNCHES[name]
                     + (CHECKER_LAUNCHES[name] if cfg.get("nsfw_checked") else 0)
                     for name in counted}
        t = cfg["timings"]
        served["jobs"][kind] = {"id": result["id"], "timings": t, "launches": counted,
                                "predicted_launches": predicted, "unet_calls": unet_calls,
                                "previews": previews, "resumed": cfg.get("resumed")}
        log(f"[resume] {kind} ({result['id']}, {cfg['model']}, {cfg['scheduler']}) on {smi}: "
            f"job {t['job_s']:.3f}s, denoise {t['denoise_s']:.3f}s ({unet_calls} UNet calls, "
            f"step {t['unet_step_ms']:.1f} ms, at the boundaries "
            f"{t.get('boundary_s', 0.0):.3f}s), decode {t['decode_s']:.3f}s; launches counted "
            f"{json.dumps(counted)}, predicted {json.dumps(predicted)} ({unet_calls} UNet calls "
            f"x {json.dumps(per_call[model])} + {1 + previews} decodes)"
            + (f"; resumed {json.dumps(cfg['resumed'])}" if cfg.get("resumed") else ""))
        if hold:
            check(counted == predicted, f"{kind}: launches {counted} != predicted {predicted}")

    def partials(job_id: str, kind: str) -> list:
        return [p for p in hive.partials if p["job_id"] == job_id and p["kind"] == kind]

    try:
        t0 = time.perf_counter()
        plain_w, armed_w = worker(registry), worker(registry, chunk, RESUME_CKPT_EVERY, 1)
        check(plain_w.capabilities()["resume_capable"] == 0
              and armed_w.capabilities()["resume_capable"] == 1, "resume_capable advertised "
              "where it should not be, or not where it should")
        # 1. the armed job against the same job with chunking off
        # chunking off, chunked with nothing armed (the boundaries' syncs are
        # its only cost), in turns: off, chunked, chunked, off
        chunked_w = worker(registry, chunk)
        turns = {}
        for k, (w, kind) in enumerate(((plain_w, "resume_plain"), (chunked_w, "resume_chunked"),
                                       (chunked_w, None), (plain_w, None))):
            job_id = f"resume-turn-{k}"
            turns[k] = serve(w, [job(job_id, sdxl, size_xl, 1300)], kind)[job_id]
            if kind is not None:
                hold_job(kind, turns[k], sdxl, steps)
        want = _pixels(turns[0])
        check(all((_pixels(r) == want).all() for r in turns.values()),
              "a chunked job's image differs from the same job served with chunking off")
        off_s = [turns[k]["pipeline_config"]["timings"]["job_s"] for k in (0, 3)]
        on_s = [turns[k]["pipeline_config"]["timings"]["job_s"] for k in (1, 2)]
        served["job_s_off"], served["job_s_chunked"] = off_s, on_s
        log(f"[resume] job_s in turns: off {off_s[0]:.3f}s, chunked {on_s[0]:.3f}s, chunked "
            f"{on_s[1]:.3f}s, off {off_s[1]:.3f}s: chunked/off "
            f"{sum(on_s) / sum(off_s):.4f}")
        armed_job = job("resume-armed", sdxl, size_xl, 1300)
        armed = serve(armed_w, [armed_job], "resume_armed")["resume-armed"]
        check((_pixels(armed) == want).all(), "the armed job's image differs from the same job "
              "served with chunking off")
        ckpts, previews = partials("resume-armed", "checkpoint"), partials("resume-armed",
                                                                           "preview")
        bounds = list(range(chunk, steps, chunk))
        check([p["step"] for p in ckpts] == bounds[RESUME_CKPT_EVERY - 1::RESUME_CKPT_EVERY],
              f"checkpoints at {[p['step'] for p in ckpts]}")
        check([p["step"] for p in previews] == bounds,
              f"previews at {[p['step'] for p in previews]}")
        for p in previews:
            image = Image.open(io.BytesIO(hive.artifacts[p["sha256"]]))
            check(image.format == "JPEG" and image.size == (size_xl, size_xl),
                  f"preview at step {p['step']}: {image.format} {image.size}")
            image.load()
        hold_job("resume_armed", armed, sdxl, steps)
        served["checkpoint_bytes"] = [p["bytes"] for p in ckpts]
        served["preview_bytes"] = [p["bytes"] for p in previews]
        # where a preview's time goes: the decode, the copy to the host and
        # the JPEG, each alone, on the armed job's canvas
        from chiaswarm_tpu_torch.device import synchronize
        from chiaswarm_tpu_torch.post_processors.output_processor import image_to_buffer, to_pil

        pipe = registry.get_pipeline(sdxl)
        lat = torch.randn((1, pipe.latent_channels, size_xl // pipe.latent_factor,
                           size_xl // pipe.latent_factor), device=device)
        parts = {"decode_to_host": [], "jpeg": []}
        for _ in range(3):
            synchronize(pipe.device)
            t1 = time.perf_counter()
            px = pipe.decode(lat)
            parts["decode_to_host"].append(time.perf_counter() - t1)
            t1 = time.perf_counter()
            image_to_buffer(to_pil(px[0]), "image/jpeg")
            parts["jpeg"].append(time.perf_counter() - t1)
        served["preview_parts_s"] = {k: min(v) for k, v in parts.items()}
        log(f"[resume] a preview alone: decode and copy to the host "
            f"{served['preview_parts_s']['decode_to_host']:.4f}s, JPEG "
            f"{served['preview_parts_s']['jpeg']:.4f}s (best of 3)")
        log(f"[resume] checkpoints at steps {[p['step'] for p in ckpts]}, "
            f"{served['checkpoint_bytes']} bytes each blob; previews at steps "
            f"{[p['step'] for p in previews]}, JPEG {served['preview_bytes']} bytes; "
            f"job_s chunked and armed {armed['pipeline_config']['timings']['job_s']:.3f}s")
        # 2. redelivery with the step-20 offer, then with a wrong signature
        resume_w = worker(registry, chunk, RESUME_CKPT_EVERY, 1)
        resumed = serve(resume_w, [armed_job], "resume_resumed", redeliver=True)
        resumed = resumed["resume-armed"]
        check((_pixels(resumed) == want).all(), "the resumed job's image differs")
        last = ckpts[-1]["step"]
        check(resumed["pipeline_config"].get("resumed")
              == {"from_step": last, "recomputed_steps": steps - last},
              f"resumed {resumed['pipeline_config'].get('resumed')}")
        hold_job("resume_resumed", resumed, sdxl, steps - last)
        from chiaswarm_tpu_torch import checkpoint

        cut = checkpoint.unpack(hive.artifacts[ckpts[-1]["sha256"]])
        hive.put_checkpoint("resume-armed", checkpoint.pack(
            cut["step"], cut["latents"], cut["state_leaves"], "f" * 16, cut["rng"]),
            cut["step"], "f" * 16)
        wrong = serve(resume_w, [armed_job], "resume_wrong_signature",
                      redeliver=True)["resume-armed"]
        check((_pixels(wrong) == want).all() and "resumed" not in wrong["pipeline_config"],
              "an offer under a wrong signature did not run the full pass to the same image")
        hold_job("resume_wrong_signature", wrong, sdxl, steps)
        # 3. SD 1.5 under Euler ancestral: the generator's state travels
        sd_plain_w = worker(sd_registry)
        sd_armed_w = worker(sd_registry, chunk, RESUME_CKPT_EVERY, 1)
        anc = job("resume-ancestral", sd15, size15, 1310,
                  scheduler="EulerAncestralDiscreteScheduler")
        undisturbed = serve(sd_plain_w, [dict(anc, id="resume-ancestral-plain")])
        want15 = _pixels(undisturbed["resume-ancestral-plain"])
        armed15 = serve(sd_armed_w, [anc])["resume-ancestral"]
        resumed15 = serve(worker(sd_registry, chunk, RESUME_CKPT_EVERY, 1), [anc],
                          "resume_ancestral", redeliver=True)["resume-ancestral"]
        check((_pixels(armed15) == want15).all(), "the armed ancestral job's image differs")
        check((_pixels(resumed15) == want15).all()
              and resumed15["pipeline_config"].get("resumed", {}).get("from_step") == last,
              f"the ancestral job resumed at step {last} differs from the undisturbed one "
              f"({resumed15['pipeline_config'].get('resumed')})")
        hold_job("resume_ancestral", resumed15, sd15, steps - last)
        log(f"[resume] {sd15} Euler ancestral {size15}^2: undisturbed, armed and resumed at "
            f"step {last} give one image bit for bit")
        # 4. a solo job cancelled after its first preview, then the next job
        cancel_w = worker(registry, chunk, 0, 1)
        gone = serve(cancel_w, [job("cancel-solo", sdxl, size_xl, 1320)],
                     after_partial=["cancel-solo"])
        check(not gone, f"a cancelled job delivered {sorted(gone)}")
        record = cancel_w.cancels.get("cancel-solo", {})
        check(record.get("stage") == "executing" and "freed_at" in record,
              f"the cancel did not reach the running pass: {record}")
        # a served step of the job with chunking off, the later (warm) one
        step_s = turns[3]["pipeline_config"]["timings"]["unet_step_ms"] / 1000.0
        latency = record["freed_at"] - record["marked_at"]
        sent = hive.cancels_sent["cancel-solo"]
        served["cancel_latency_s"] = latency
        log(f"[resume] solo cancel: the hive sent it at {sent:.3f}, the worker marked it at "
            f"{record['marked_at']:.3f}, the device was free at {record['freed_at']:.3f}: "
            f"{latency:.3f}s after the mark, one chunk being {chunk} x {step_s:.4f}s")
        check(latency <= 1.5 * chunk * step_s + 0.1,
              f"the device was free {latency:.3f}s after the cancel, more than one chunk")
        after = serve(cancel_w, [job("after-cancel", sdxl, size_xl, 1321, n_steps=min(steps, 10))])
        check(list(after) == ["after-cancel"] and not after["after-cancel"].get("fatal_error"),
              "the job after the cancelled one was not served")
        # 5. a coalesced chunked pass, then one member cancelled, then all
        batch_w = worker(registry, chunk, coalesce=group_size)
        group = [job(f"group-{k}", sdxl, size_xl, 1330 + k, n_steps=batched_steps,
                     prompt=BATCH_PROMPTS[k]) for k in range(group_size)]
        reference = serve(batch_w, group)
        check(all(r["pipeline_config"].get("batched_with") == group_size
                  for r in reference.values()),
              "the reference group was not served as one pass")
        # the revocation comes two heartbeats in: the pass is running by then
        polls = 2 + int(0.25 / batch_w.heartbeat_seconds)
        member = [dict(j, id=j["id"] + "-c") for j in group]
        three = serve(batch_w, member, "group_one_cancelled",
                      on_heartbeat={member[1]["id"]: polls})
        check(sorted(three) == sorted(j["id"] for j in member if j is not member[1]),
              f"a pass with one member cancelled delivered {sorted(three)}")
        check(batch_w.cancels.get(member[1]["id"], {}).get("stage") == "executing",
              f"the member's cancel did not reach the pass: {batch_w.cancels}")
        for j, ref in zip(member, group):
            if j is not member[1]:
                check((_pixels(three[j["id"]]) == _pixels(reference[ref["id"]])).all(),
                      f"{j['id']}: differs from the same job in the pass without the cancel")
        everyone = [dict(j, id=j["id"] + "-all") for j in group]
        none = serve(batch_w, everyone, "group_all_cancelled",
                     on_heartbeat={j["id"]: polls for j in everyone})
        check(not none, f"a pass with every member cancelled delivered {sorted(none)}")
        check(all("freed_at" in batch_w.cancels.get(j["id"], {}) for j in everyone),
              f"the pass with every member cancelled did not abort: {batch_w.cancels}")
        for kind in ("group_one_cancelled", "group_all_cancelled"):
            counted = {name: launches for name, (launches, _) in paths[kind][1].items()}
            served["jobs"][kind] = {"launches": counted}
            log(f"[resume] {kind}: launches {json.dumps(counted)}")
        served["served_s"] = time.perf_counter() - t0
        check(hive.auth_failures == 0, "the hive refused the worker's bearer token")
    finally:
        hive.close()
    log(f"[resume] the resume and cancel path served in {served['served_s']:.1f}s")
    return paths, served


PLANE_TOKEN = "plane-token"


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _http(url: str, token: str | None = None, method: str = "GET", timeout: float = 60.0):
    """(status, body bytes) of one request to a worker's metrics app."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, method=method, data=b"" if method == "POST" else None)
    if token is not None:
        req.add_header("Authorization", f"Bearer {token}")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _samples(text: str) -> dict:
    """Prometheus text -> {(name, ((label, value), ...)): value}."""
    import re

    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = re.match(r'^([A-Za-z_:][A-Za-z0-9_:]*)(?:\{(.*)\})? (\S+)$', line)
        check(m is not None, f"unparsable exposition line {line!r}")
        labels = tuple(re.findall(r'(\w+)="((?:[^"\\]|\\.)*)"', m.group(2) or ""))
        out[(m.group(1), labels)] = float(m.group(3))
    return out


def _until(cond, timeout: float, what: str, step: float = 0.01) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        check(time.monotonic() < deadline, f"timed out waiting for {what}")
        time.sleep(step)


def run_beside(worker, side, max_jobs: int | None = None, timeout: float = 600.0):
    """Run `worker` on this thread's event loop (the main thread's, so that it
    installs its SIGTERM handler) while `side(worker)` runs in a thread
    beside it; -> (what `side` returned, the run's wall seconds). A side that
    fails stops the run."""
    out = {}

    async def main():
        loop = asyncio.get_running_loop()
        runner = asyncio.ensure_future(worker.run(max_jobs=max_jobs))
        t0 = time.perf_counter()
        try:
            out["side"] = await loop.run_in_executor(None, side, worker)
        except BaseException:
            worker.stop()
            raise
        await asyncio.wait_for(runner, timeout)
        out["run_s"] = time.perf_counter() - t0

    asyncio.run(main())
    return out["side"], out["run_s"]


def serve_worker_plane_path(smi: str, registry, sd_registry, xl_launches: dict,
                            device: str = "cuda", sdxl: str = SDXL, sd15: str = SD15,
                            size_xl: int = SIZE, size15: int = 512, steps: int = STEPS,
                            profile_s: float = 2.0, peak: float = 989.4,
                            hang_deadline_s: float = 3.0,
                            hold: bool = True) -> tuple[dict, dict]:
    """Phase 5, the worker plane, in the main path's registries (`sdxl` in
    `registry`, `sd15` in `sd_registry`), through workers with the metrics
    app on and the port's fake hive, under a $SDAAS_ROOT of its own:

    1. an SDXL job (DPM++ 2M), /metrics and /healthz scraped during and
       after its pass: `cost.flops` the analytic count (models/flops.py),
       `mfu` in (0, 1] and equal to `swarm_pass_mfu`, the divergence ratio
       of the pass ledger within 5% of 1, launches as the main path's; an
       SD 1.5 job's MFU; the outbox's write of the envelope timed;
    2. SDXL under `drop_submit=2`: delivered after two retries;
    3. SDXL under `kill_before_ack=1`, then a new worker on the same root:
       the hive receives the envelope twice, byte for byte;
    4. SDXL refused with a 422: parked on disk with its reason;
    5. SD 1.5 under `hang_denoise=1` with `job_deadline_s` at
       `hang_deadline_s` (a few times an SD 1.5 job's): the
       transient envelope, /healthz degraded, the probe (a matmul on the
       device) returns it once `release_hangs()` lets the hung pass end,
       and the next job is served;
    6. SIGTERM during an SDXL pass: the pass's envelope is delivered before
       `run` returns, the job queued after it is not taken;
    7. /debug/profile for `profile_s` during an SDXL pass: a Chrome trace
       that holds the attention and GroupNorm kernels.

    `peak` is the card's peak the envelopes must name. On the CPU (a
    rehearsal, with `BENCH_PEAK_TFLOPS` set) the card's memory and the
    profile's kernels are not held, and launches are printed, not held.

    -> ({job kind: (1, {kernel: (launches, {shape: launches})})}, served)."""
    import os
    import shutil
    import signal
    import tempfile

    from chiaswarm_tpu_torch import faults, programs, telemetry
    from chiaswarm_tpu_torch.fake_hive import FakeHive
    from chiaswarm_tpu_torch.models.flops import denoise_flops
    from chiaswarm_tpu_torch.ops.flash_attention import COUNTER as FA_COUNTER
    from chiaswarm_tpu_torch.ops.group_norm import COUNTER as GN_COUNTER
    from chiaswarm_tpu_torch.outbox import Outbox
    from chiaswarm_tpu_torch.settings import Settings
    from chiaswarm_tpu_torch.worker import Worker

    counters = {"flash_attention": FA_COUNTER, "group_norm": GN_COUNTER}
    per_call = {sdxl: xl_launches, sd15: SD_UNET_LAUNCHES}
    root = Path(tempfile.mkdtemp(prefix="chip-smoke-plane-"))
    saved_root = os.environ.get("SDAAS_ROOT")
    os.environ["SDAAS_ROOT"] = str(root)
    hive = FakeHive(token=PLANE_TOKEN)
    paths, served = {}, {"jobs": {}}
    retries = telemetry.REGISTRY.get("swarm_outbox_retries_total")

    def worker(reg, **overrides):
        fields = dict(sdaas_token=PLANE_TOKEN, sdaas_uri=hive.uri, worker_name="chip-smoke-plane",
                      model_root_dir=reg.model_root_dir, max_coalesce=1,
                      metrics_port=_free_port(), profiler_capture=True)
        fields.update(overrides)
        return Worker(settings=Settings(**fields), device=device, registry=reg,
                      poll_seconds=0.05, heartbeat_seconds=HEARTBEAT_SECONDS)

    def job(job_id: str, model: str, size: int, seed: int):
        return {"id": job_id, "workflow": "txt2img", "model_name": model,
                "prompt": "a lighthouse on a cliff at dusk, the worker plane",
                "negative_prompt": "blurry", "height": size, "width": size,
                "num_inference_steps": steps, "guidance_scale": 7.0, "seed": seed,
                "content_type": "image/png",
                "parameters": {"scheduler_type": "DPMSolverMultistepScheduler"}}

    def base(w) -> str:
        return f"http://127.0.0.1:{w.settings.metrics_port}"

    def scrape(w) -> dict:
        status, text = _http(f"{base(w)}/metrics")
        check(status == 200, f"/metrics answered {status}")
        health_status, health = _http(f"{base(w)}/healthz")
        return {"metrics": _samples(text.decode()), "health_status": health_status,
                "health": json.loads(health)}

    def counted(kind: str, before: dict) -> None:
        after = _snapshot(counters)
        paths[kind] = (1, {name: (after[name][0] - before[name][0],
                                  after[name][1] - before[name][1]) for name in counters})

    def spooled() -> list:
        return sorted(p.name for p in (root / "outbox").iterdir()
                      if p.name.endswith((".json", ".parked")))

    try:
        t_path = time.perf_counter()
        # 1. the cost plane: SDXL scraped during and after its pass, then SD 1.5
        for kind, reg, model, size in (("plane_sdxl", registry, sdxl, size_xl),
                                       ("plane_sd15", sd_registry, sd15, size15)):
            w = worker(reg)
            job_id = f"{kind}-cost"
            seen = len(hive.results)
            hive.enqueue(job(job_id, model, size, 1400))

            def side(w):
                _until(lambda: w._busy, 120, "the pass to start")
                during = scrape(w)
                _until(lambda: len(hive.results) > seen and w.outbox.depth == 0, 300,
                       "the envelope's delivery")
                after = scrape(w)
                after["programs"] = json.loads(_http(f"{base(w)}/debug/programs")[1])
                after["memory"] = json.loads(_http(f"{base(w)}/debug/memory")[1])
                w.stop()
                return during, after

            before = _snapshot(counters)
            (during, after), run_s = run_beside(w, side)
            counted(kind, before)
            [result] = [r for r in hive.results if r["id"] == job_id]
            cfg = result["pipeline_config"]
            check(not result.get("fatal_error") and "error" not in cfg,
                  f"{job_id}: {cfg.get('error')}")
            image = decode_artifact(result["artifacts"]["primary"])
            check(image.shape == (size, size, 3) and int(image.max()) != int(image.min()),
                  f"{job_id}: image {image.shape}")
            pipe = reg.get_pipeline(model)
            lh = size // pipe.latent_factor
            analytic = denoise_flops(pipe.unet.config, lh, lh, 1, steps)
            cost, t = cfg["cost"], cfg["timings"]
            check(cost["flops"] == cost["pass_flops"] == int(round(analytic)),
                  f"{job_id}: cost.flops {cost['flops']} != the analytic {analytic:.0f}")
            check(cfg["unet_tflops"] == round(analytic / 1e12, 4),
                  f"{job_id}: unet_tflops {cfg['unet_tflops']}")
            check(cfg["geometry"] == {"data": 1, "tensor": 1, "seq": 1}, f"{job_id}: geometry")
            mfu = cost["mfu"]
            check(mfu is not None and 0.0 < mfu <= 1.0, f"{job_id}: mfu {mfu}")
            check(cost["peak_tflops_per_chip"] == peak,
                  f"{job_id}: peak {cost['peak_tflops_per_chip']}")
            metrics = after["metrics"]
            gauge = metrics.get(("swarm_pass_mfu", (("model", model),
                                                    ("geometry", "replicated"))))
            check(gauge == mfu, f"{job_id}: swarm_pass_mfu {gauge} != the stamp's {mfu}")
            ratio = metrics.get(("swarm_flops_divergence_ratio", (("model", model),)))
            check(ratio is not None and abs(ratio - 1.0) <= 0.05,
                  f"{job_id}: swarm_flops_divergence_ratio {ratio}")
            # this job's pass key, as SDPipeline.run keys it
            key = repr(("txt2img", lh, lh, 1, steps, "DPMSolverMultistepScheduler", False, 0,
                        None))
            entries = [e for e in after["programs"]["programs"]
                       if e["model"] == model and e["key"] == key]
            check(len(entries) == 1 and entries[0]["counted_call_flops"],
                  f"{job_id}: the pass ledger's rows of {key}: {entries}")
            entry = entries[0]
            check(during["health_status"] == 200 and during["health"]["slices"][0]["busy"],
                  f"{job_id}: /healthz during the pass {during['health']}")
            check(after["health_status"] == 200 and after["health"]["status"] == "ok"
                  and after["health"]["outbox"]["depth"] == 0,
                  f"{job_id}: /healthz after the pass {after['health']}")
            stores = after["memory"]["stores"]
            card = {"bytes_in_use": 0, "bytes_limit": 0}
            if device == "cuda":
                [card] = after["memory"]["devices"]
            check(after["memory"]["total_bytes"] == sum(s["bytes"] for s in stores.values())
                  and card["bytes_limit"] >= card["bytes_in_use"] >= 0
                  and (device != "cuda" or card["bytes_in_use"] > 0),
                  f"{job_id}: /debug/memory {after['memory']}")
            launches = {name: paths[kind][1][name][0] for name in counters}
            predicted = {name: steps * per_call[model][name] + DECODE_LAUNCHES[name]
                         + (CHECKER_LAUNCHES[name] if cfg.get("nsfw_checked") else 0)
                         for name in counters}
            served["jobs"][kind] = {
                "timings": t, "cost": cost, "unet_tflops": cfg["unet_tflops"],
                "divergence": ratio, "ledger": entry, "launches": launches,
                "predicted_launches": predicted, "run_s": run_s,
                "device_memory": card, "stores": {k: v["bytes"] for k, v in stores.items()}}
            log(f"[plane] {job_id} ({model} {size}^2, {steps} steps) on {smi}: job "
                f"{t['job_s']:.3f}s, denoise {t['denoise_s']:.3f}s + decode {t['decode_s']:.3f}s;"
                f" unet_tflops {cfg['unet_tflops']}, {cost['tflops_per_s']} TFLOP/s over "
                f"denoise + decode, MFU {mfu} of {cost['peak_tflops_per_chip']} (gauge {gauge});"
                f" divergence {ratio} (counted {entry['counted_call_flops']}, of which attention "
                f"{entry['attention_flops']}, analytic {entry['analytic_call_flops']:.0f} a "
                f"call); launches {json.dumps(launches)}, predicted {json.dumps(predicted)}; "
                f"card {card['bytes_in_use'] / 2**30:.1f} of {card['bytes_limit'] / 2**30:.1f}"
                f" GiB in use")
            if hold:
                check(launches == predicted, f"{job_id}: launches {launches} != {predicted}")
            if kind == "plane_sdxl":
                # what the outbox's write costs this envelope (warm page cache)
                box = Outbox(root / "spool-timing")
                times = []
                for _ in range(5):
                    t0 = time.perf_counter()
                    entry_ = box.spool(result)
                    times.append(time.perf_counter() - t0)
                    box.delivered(entry_)
                nbytes = len(hive.bodies[job_id][0])
                served["spool_ms"] = sorted(1000 * x for x in times)
                log(f"[plane] the outbox's write of a {size}^2 envelope ({nbytes} bytes of "
                    f"JSON): {served['spool_ms'][2]:.2f} ms median of 5 (min "
                    f"{served['spool_ms'][0]:.2f}, max {served['spool_ms'][4]:.2f}), tmp + "
                    "rename, warm page cache")
        # 2. drop_submit=2: delivered after two retries
        w = worker(registry)
        faults.configure("drop_submit=2")
        before_retries = retries.value()
        hive.enqueue(job("plane-drop", sdxl, size_xl, 1401))
        asyncio.run(w.run(max_jobs=1))
        check(faults.get_plan().fired("drop_submit") == 2
              and retries.value() - before_retries == 2
              and len(hive.bodies.get("plane-drop", [])) == 1 and not spooled(),
              f"drop_submit: fired {faults.get_plan().fired('drop_submit')}, retries "
              f"{retries.value() - before_retries}, bodies {len(hive.bodies.get('plane-drop', []))}")
        faults.configure("")
        log("[plane] drop_submit=2: delivered after 2 retries, once")
        # 3. kill_before_ack=1, then a new worker on the same root
        faults.configure("kill_before_ack=1")
        w = worker(registry)
        hive.enqueue(job("plane-kill", sdxl, size_xl, 1402))
        asyncio.run(w.run(max_jobs=1))
        faults.configure("")
        check(w.crashed and len(hive.bodies["plane-kill"]) == 1 and len(spooled()) == 1,
              f"kill_before_ack: crashed {w.crashed}, spool {spooled()}")
        w2 = worker(registry)
        t0 = time.perf_counter()
        run_beside(w2, lambda w: (_until(lambda: len(hive.bodies["plane-kill"]) == 2
                                         and w.outbox.depth == 0, 120, "the redelivery"),
                                  w.stop()))
        bodies = hive.bodies["plane-kill"]
        check(bodies[0] == bodies[1] and not spooled(),
              "the redelivered envelope differs from the first delivery")
        served["redelivery"] = {"bytes": len(bodies[0]), "s": time.perf_counter() - t0}
        log(f"[plane] kill_before_ack=1: a new worker redelivered the spooled envelope "
            f"({len(bodies[0])} bytes) byte for byte; duplicates at the hive {hive.duplicates}")
        # 4. a permanent refusal is parked
        hive.refuse("plane-refused", 422)
        w = worker(registry)
        hive.enqueue(job("plane-refused", sdxl, size_xl, 1403))
        asyncio.run(w.run(max_jobs=1))
        check(len(spooled()) == 1, f"the spool after the refusal: {spooled()}")
        parked = spooled()[0]
        payload = json.loads((root / "outbox" / parked).read_text())
        check(parked.endswith("-plane-refused.json.parked") and "HTTP 422" in
              payload["park_reason"] and "plane-refused" not in hive.bodies,
              f"the refused envelope: {parked}, {payload.get('park_reason')}")
        (root / "outbox" / parked).unlink()
        log(f"[plane] a 422 refusal parked on disk: {parked} ({payload['park_reason']!r})")
        # 5. the watchdog: a hung SD 1.5 pass, quarantine, the probe
        faults.configure("hang_denoise=1", hang_timeout_s=600.0)
        w = worker(sd_registry, job_deadline_s=hang_deadline_s, job_deadline_compile_scale=1.0,
                   quarantine_probe_grace_s=120.0)
        hive.enqueue(job("plane-hung", sd15, size15, 1404))

        def watchdog(w):
            _until(lambda: "plane-hung" in hive.bodies, 60, "the transient envelope")
            status, health = _http(f"{base(w)}/healthz")
            hive.enqueue(job("plane-after-hang", sd15, size15, 1405))
            time.sleep(0.5)
            held = "plane-after-hang" not in hive.bodies
            t_release = time.monotonic()
            faults.get_plan().release_hangs()
            _until(lambda: "plane-after-hang" in hive.bodies, 120, "the job after the hang")
            return status, json.loads(health), held, t_release

        (status, health, held, t_release), _ = run_beside(w, watchdog, max_jobs=2)
        faults.configure("")
        hung = json.loads(hive.bodies["plane-hung"][0])
        after_hang = json.loads(hive.bodies["plane-after-hang"][0])
        probe = w.last_probe or {}
        check("watchdog" in hung["pipeline_config"].get("error", "")
              and not hung.get("fatal_error"), f"the hung job's envelope {hung['pipeline_config']}")
        check(status == 503 and health["status"] == "degraded"
              and health["slices"][0]["state"] == "quarantined" and held,
              f"/healthz while quarantined: {status} {health}")
        check(probe.get("outcome") == "ok" and probe.get("device", "").startswith(device),
              f"the probe: {probe}")
        check("error" not in after_hang["pipeline_config"], "the job after the hang failed")
        served["watchdog"] = {"probe": probe, "health": health,
                              "probe_after_release_s": probe["at"] - t_release}
        log(f"[plane] hang_denoise=1 with job_deadline_s {hang_deadline_s:g}: transient "
            "envelope, /healthz "
            f"{status} {health['degraded_reasons']}; the probe on {probe['device']} passed "
            f"{probe['at'] - t_release:.3f}s after the release (the hung pass ran on), the next "
            "job served")
        # 6. SIGTERM during an SDXL pass: the envelope lands before run returns
        w = worker(registry)
        hive.enqueue(job("plane-sigterm", sdxl, size_xl, 1406))

        def sigterm(w):
            _until(lambda: w._busy, 120, "the pass to start")
            time.sleep(0.5)
            check(signal.getsignal(signal.SIGTERM) not in (signal.SIG_DFL, signal.SIG_IGN, None),
                  "the worker's loop does not handle SIGTERM")
            t_sig = time.monotonic()
            os.kill(os.getpid(), signal.SIGTERM)
            _until(lambda: w.health()["draining"], 30, "the drain")
            hive.enqueue(job("plane-after-sigterm", sdxl, size_xl, 1407))
            return t_sig

        t_sig, _ = run_beside(w, sigterm)
        t_end = time.monotonic()
        check("plane-sigterm" in hive.bodies and not spooled()
              and "plane-after-sigterm" not in hive.bodies,
              f"the drain: delivered {sorted(hive.bodies)}, spool {spooled()}")
        hive.jobs.clear()
        sig = json.loads(hive.bodies["plane-sigterm"][0])["pipeline_config"]["timings"]
        served["drain_s"] = t_end - t_sig
        log(f"[plane] SIGTERM 0.5 s into an SDXL pass: run returned {t_end - t_sig:.3f}s later "
            f"with the envelope delivered (its job {sig['job_s']:.3f}s); the job queued after "
            "it was not taken")
        # 7. /debug/profile during an SDXL pass
        w = worker(registry)
        hive.enqueue(job("plane-profile", sdxl, size_xl, 1408))

        def capture(w):
            _until(lambda: w._busy, 120, "the pass to start")
            anonymous = _http(f"{base(w)}/debug/profile?seconds=0.1", method="POST")[0]
            status, body = _http(f"{base(w)}/debug/profile?seconds={profile_s}",
                                 token=PLANE_TOKEN, method="POST", timeout=300)
            _until(lambda: "plane-profile" in hive.bodies, 300, "the profiled job")
            w.stop()
            return anonymous, status, json.loads(body)

        (anonymous, status, detail), _ = run_beside(w, capture)
        check(anonymous == 401 and status == 200, f"/debug/profile: {anonymous}, {status}")
        trace = json.loads(Path(detail["path"]).read_text())
        kernels = Counter()
        for event in trace.get("traceEvents", []):
            if event.get("cat") == "kernel":
                for mark in ("flash_fwd_wgmma", "gn_fused"):
                    if mark in event.get("name", ""):
                        kernels[mark] += 1
        check(device != "cuda" or (kernels["flash_fwd_wgmma"] > 0 and kernels["gn_fused"] > 0),
              f"the profile holds {dict(kernels)}")
        served["profile"] = {"bytes": detail["bytes"], "kernels": dict(kernels)}
        log(f"[plane] /debug/profile {profile_s}s during an SDXL pass: {detail['bytes']} bytes "
            f"of Chrome trace, {dict(kernels)} kernel events; anonymous 401")
        check(hive.auth_failures == 0, "the hive refused the worker's bearer token")
        served["served_s"] = time.perf_counter() - t_path
        served["ledger"] = programs.snapshot()["kernels"]
    finally:
        faults.configure("")
        hive.close()
        if saved_root is None:
            os.environ.pop("SDAAS_ROOT", None)
        else:
            os.environ["SDAAS_ROOT"] = saved_root
        shutil.rmtree(root, ignore_errors=True)
    log(f"[plane] the worker-plane path served in {served['served_s']:.1f}s; kernel libraries "
        + ", ".join(f"{k['name']} {k['bytes']} B (build {k['build_s']} s)"
                    for k in served["ledger"]))
    return paths, served


HIVE_TOKEN = "hive-token"
# the upscale workflow's tolerance against the monolithic job's image: its
# mean |difference| over that of the same rows upscaled under two seeds
UPSCALE_SPREAD_RATIO = 1.25


def serve_hive_plane_path(smi: str, registry, sd_registry, xl_launches: dict,
                          device: str = "cuda", sdxl: str = SDXL, sd15: str = SD15,
                          size_xl: int = SIZE, size15: int = 512, steps: int = STEPS,
                          gang_steps: int = BATCHED_STEPS, gang: int = 4, big_gang: int = 9,
                          seed_upscaler: str = UPSCALER, checker: str = CHECKER,
                          backoff_cap_s: float = 0.2, hold: bool = True) -> tuple[dict, dict]:
    """Phase 5, several hives, gangs and stage graphs, through workers and
    the port's fake hives on localhost, in a registry of its own over a
    temporary root that shares the main path's resident `sdxl` (from
    `registry`) and `sd15` (from `sd_registry`) pipelines and holds the
    SD-x2 upscaler and the safety checker (`seed_upscaler`'s and `checker`'s
    seeded weights written under the root, read back; a test name is
    random-initialised), under a $SDAAS_ROOT of its own:

    1. gang: `gang` SDXL `size_xl`^2 `gang_steps`-step jobs in one reply
       under one `trace.gang` id: one pass (flush reason "gang", no linger),
       every envelope echoing the trace; the same jobs again, coalesced by
       the linger: the decoded pixels equal bit for bit; `big_gang` SD 1.5
       jobs as one gang under `max_coalesce` 8: passes of 8 and 1; the first
       poll advertises `gang_rows`;
    2. failover: primary and standby hives. An SD 1.5 `steps`-step job taken
       from the primary, whose /results then answers 409 with epoch 2: the
       envelope lands on the standby with `X-Hive-Epoch: 2`, nothing is
       parked, `hive_epoch` under $SDAAS_ROOT reads 2; the standby goes dark
       (every connection closed): after `hive_failover_errors` failed polls
       (the backoff capped at `backoff_cap_s`) the worker pins the primary
       again and serves a second job there; `swarm_hive_failover_total`
       moved by 2 and /healthz's `hive` block names the primary;
    3. stage graph: an SDXL txt2img workflow (encode / denoise with the raw
       handoff / decode) served stage by stage, encode and decode on the
       stage lane, its final artifact equal bit for bit to the monolithic
       job's (same seed) with the same launches; an SD 1.5 workflow with
       `upscale` (encode / denoise / upscale / decode): the rows handed to
       the upscaler equal the monolithic job's image bit for bit, the final
       image equals the upscaler run directly on them with the stage's
       stamped seed bit for bit, and against the monolithic `upscale` job's
       image its mean |difference| is at most UPSCALE_SPREAD_RATIO x that
       of the same rows upscaled under two seeds (the stage-job carries no
       seed, as the repo's hive expands it, so its noise is drawn from
       another generator); two SDXL workflows, the second submitted when
       the first's denoise starts: the first's decode (the checker on the
       card, from the lane's thread) runs inside the second's pass;
    4. stats: the last poll's `stats` holds EWMAs for `denoise` and the
       host stages; `swarm_queue_depth{queue="stage"}` reads 0.

    Launches are counted per job kind and held (with `hold`; the CPU
    rehearsal prints them) to the UNet calls, decodes, encodes, upscaler
    calls and one checker call a job. -> ({job kind: (jobs, {kernel:
    (launches, {shape: launches})})}, served)."""
    import gc
    import os
    import shutil
    import tempfile

    import numpy as np

    from chiaswarm_tpu_torch import batching, telemetry
    from chiaswarm_tpu_torch.fake_hive import FakeHive
    from chiaswarm_tpu_torch.models.safety import TINY_SAFETY, SafetyConfig
    from chiaswarm_tpu_torch.ops.flash_attention import COUNTER as FA_COUNTER
    from chiaswarm_tpu_torch.ops.group_norm import COUNTER as GN_COUNTER
    from chiaswarm_tpu_torch.pipelines.common import pad_bucket
    from chiaswarm_tpu_torch.pipelines.stable_diffusion import UPSCALE_PIPELINE
    from chiaswarm_tpu_torch.pipelines.upscale import LatentUpscalePipeline, upscaler_name_for
    from chiaswarm_tpu_torch.registry import Registry
    from chiaswarm_tpu_torch.settings import Settings
    from chiaswarm_tpu_torch.weights import is_test_model
    from chiaswarm_tpu_torch.worker import Worker
    from chiaswarm_tpu_torch.workflows.stages import unpack_raw

    on_card = torch.device(device).type == "cuda"
    counters = {"flash_attention": FA_COUNTER, "group_norm": GN_COUNTER}
    root = Path(tempfile.mkdtemp(prefix="chip-smoke-hive-"))
    saved_root = os.environ.get("SDAAS_ROOT")
    os.environ["SDAAS_ROOT"] = str(root / "sdaas")
    paths, served = {}, {"launches": {}}
    hives: list = []
    failovers = telemetry.REGISTRY.get("swarm_hive_failover_total")
    flushes = batching._FLUSHES
    up_name = upscaler_name_for(sd15)
    routes = Counter(FA_COUNTER.routes)
    try:
        t_path = time.perf_counter()
        # the upscaler first, in an empty registry, so that its build can
        # evict nothing; the main path's pipelines are shared, not rebuilt
        reg = Registry(torch.device(device), str(root / "models"), safety_checker_model=checker)
        t0 = time.perf_counter()
        if not is_test_model(up_name):
            seeded = LatentUpscalePipeline(seed_upscaler, device=device, allow_random_init=True)
            write_upscaler(seeded, root / "models" / up_name, UPSCALER_SCHEDULER)
            del seeded
            gc.collect()
        write_checker(root / "models" / checker,
                      TINY_SAFETY if is_test_model(checker) else SafetyConfig(), 71, device)
        upscaler = reg.get_pipeline(up_name, pipeline_type=UPSCALE_PIPELINE)
        nsfw = reg.safety_checker()
        check(nsfw.available and nsfw.weights_source == "checkpoint"
              and str(nsfw.device).startswith(device),
              f"{checker}: available {nsfw.available}, device {getattr(nsfw, 'device', None)}")
        for model, source in ((sdxl, registry), (sd15, sd_registry)):
            reg._pipelines[(model, "sd")] = source.get_pipeline(model, allow_random_init=True)
        served["setup_s"] = time.perf_counter() - t0
        log(f"[hive] {up_name} ({upscaler.weights_source}) and {checker} written and loaded "
            f"in {served['setup_s']:.1f}s beside the shared {sdxl} and {sd15} on {smi}")

        def make_hive():
            h = FakeHive(token=HIVE_TOKEN)
            hives.append(h)
            return h

        def worker(uris: list, **overrides):
            fields = dict(sdaas_token=HIVE_TOKEN, sdaas_uri=uris[0],
                          sdaas_uris=",".join(uris), worker_name="chip-smoke-hive",
                          model_root_dir=reg.model_root_dir, max_coalesce=8,
                          metrics_port=_free_port())
            fields.update(overrides)
            return Worker(settings=Settings(**fields), device=device, registry=reg,
                          poll_seconds=0.05, heartbeat_seconds=HEARTBEAT_SECONDS,
                          backoff_cap_seconds=backoff_cap_s)

        def job(job_id, model, size, n_steps, seed, prompt=BATCH_PROMPTS[0], **extra):
            return {"id": job_id, "workflow": "txt2img", "model_name": model, "prompt": prompt,
                    "negative_prompt": "blurry", "height": size, "width": size,
                    "num_inference_steps": n_steps, "guidance_scale": 7.0, "seed": seed,
                    "content_type": "image/png",
                    "parameters": {"scheduler_type": "DPMSolverMultistepScheduler"}, **extra}

        def per_job(model, n_steps, decodes=1, upscale=False) -> dict:
            """One job's launches: its UNet calls, its decodes, the upscaler's
            K-UNet calls with its encode and 2x decode, and one checker call."""
            per_call = xl_launches if model == sdxl else SD_UNET_LAUNCHES
            return {k: n_steps * per_call[k] + decodes * DECODE_LAUNCHES[k]
                    + (UPSCALE_STEPS * K_UNET_LAUNCHES[k] + ENCODE_LAUNCHES[k]
                       + DECODE_LAUNCHES[k] if upscale else 0) + CHECKER_LAUNCHES[k]
                    for k in counters}

        def count(kind: str, jobs: int, before: dict, predicted: dict) -> None:
            after = _snapshot(counters)
            paths[kind] = (jobs, {name: (after[name][0] - before[name][0],
                                         after[name][1] - before[name][1])
                                  for name in counters})
            launches = {name: paths[kind][1][name][0] for name in counters}
            served["launches"][kind] = {"launches": launches, "predicted": predicted}
            log(f"[hive] {kind}: {jobs} job(s), launches {json.dumps(launches)}, predicted "
                f"{json.dumps(predicted)}")
            if hold:
                check(launches == predicted, f"{kind}: launches {launches} != {predicted}")

        def image(result) -> np.ndarray:
            cfg = result["pipeline_config"]
            check(not result.get("fatal_error") and "error" not in cfg,
                  f"{result['id']}: {cfg.get('error')}")
            return decode_artifact(result["artifacts"]["primary"])

        def wait(h, job_ids, timeout=600):
            _until(lambda: all(j in h.bodies for j in job_ids), timeout,
                   f"the envelopes of {job_ids}")
            return {j: json.loads(h.bodies[j][-1]) for j in job_ids}

        # 1. gangs
        hive = make_hive()
        w = worker([hive.uri])

        def gangs(w):
            out = {}
            jobs = [job(f"gang-{i}", sdxl, size_xl, gang_steps, 1500 + i, BATCH_PROMPTS[i])
                    for i in range(gang)]
            for kind, label in (("hive_gang_sdxl", "gang"), ("hive_linger_sdxl", "linger")):
                before, flushed = _snapshot(counters), {
                    r: flushes.value(reason=r) for r in ("gang", "linger", "size")}
                ids = [f"{label}-{i}" for i in range(gang)]
                batch = [dict(j, id=i) for j, i in zip(jobs, ids)]
                t0 = time.perf_counter()
                gang_id = hive.enqueue_gang(*batch) if label == "gang" else hive.enqueue(*batch)
                out[label] = {"results": wait(hive, ids), "s": time.perf_counter() - t0,
                              "gang_id": gang_id,
                              "flushed": {r: flushes.value(reason=r) - n
                                          for r, n in flushed.items()}}
                count(kind, gang, before, {k: gang_steps * xl_launches[k]
                                           + gang * (DECODE_LAUNCHES[k] + CHECKER_LAUNCHES[k])
                                           for k in counters})
            before, flushed = _snapshot(counters), flushes.value(reason="gang")
            ids = [f"gang15-{i}" for i in range(big_gang)]
            t0 = time.perf_counter()
            hive.enqueue_gang(*[job(i, sd15, size15, gang_steps, 1520 + k,
                                    BATCH_PROMPTS[k % len(BATCH_PROMPTS)])
                                for k, i in enumerate(ids)])
            out["big"] = {"results": wait(hive, ids), "s": time.perf_counter() - t0,
                          "flushed": flushes.value(reason="gang") - flushed}
            passes = -(-big_gang // 8)
            count("hive_gang_sd15", big_gang, before,
                  {k: passes * (gang_steps * SD_UNET_LAUNCHES[k] + DECODE_LAUNCHES[k])
                   + big_gang * CHECKER_LAUNCHES[k] for k in counters})
            w.stop()
            return out

        got, run_s = run_beside(w, gangs)
        first = hive.polls[0]
        check(first.get("gang_rows") == "8" and first.get("queue_depth") == "0",
              f"the first poll: gang_rows {first.get('gang_rows')}, queue_depth "
              f"{first.get('queue_depth')}")
        for label in ("gang", "linger"):
            flushed = got[label]["flushed"]
            want = {"gang": 1, "linger": 0, "size": 0} if label == "gang" else {
                "gang": 0, "linger": 1, "size": 0}
            check(flushed == want, f"{label}: flushes {flushed}")
            for i in range(gang):
                cfg = got[label]["results"][f"{label}-{i}"]["pipeline_config"]
                check(cfg.get("batched_with") == gang and cfg.get("padded_rows") == pad_bucket(gang)
                      and cfg.get("batch_rows") == [i, 1] and cfg.get("nsfw_checked") is True,
                      f"{label}-{i}: batched_with {cfg.get('batched_with')}, padded_rows "
                      f"{cfg.get('padded_rows')}, batch_rows {cfg.get('batch_rows')}, "
                      f"nsfw_checked {cfg.get('nsfw_checked')}")
                trace = cfg.get("trace")
                if label == "gang":
                    check(isinstance(trace, dict) and trace["gang"]["id"] == got["gang"]["gang_id"]
                          and trace["lingered_s"] == 0.0 and trace["coalesced_with"] == gang - 1
                          and "received_wall" in trace, f"gang-{i}: trace {trace}")
                else:
                    check(trace is None, f"linger-{i}: trace {trace}")
        equal = [np.array_equal(image(got["gang"]["results"][f"gang-{i}"]),
                                image(got["linger"]["results"][f"linger-{i}"]))
                 for i in range(gang)]
        check(all(equal), f"gang against linger, bit for bit: {equal}")
        timings = {label: got[label]["results"][f"{label}-0"]["pipeline_config"]["timings"]
                   for label in ("gang", "linger")}
        big = [got["big"]["results"][f"gang15-{k}"]["pipeline_config"] for k in range(big_gang)]
        sizes = sorted(c.get("batched_with", 1) for c in big)
        check(got["big"]["flushed"] == 2 and sizes == [1] + [8] * 8
              and all(c["nsfw_checked"] for c in big),
              f"the gang of {big_gang}: flushes {got['big']['flushed']}, batched_with {sizes}")
        for k in range(big_gang):
            image(got["big"]["results"][f"gang15-{k}"])
        served["gang"] = {"s": got["gang"]["s"], "linger_s": got["linger"]["s"],
                          "big_s": got["big"]["s"], "timings": timings, "run_s": run_s}
        log(f"[hive] gang: {gang} SDXL {size_xl}^2 {gang_steps}-step jobs in one reply, one pass "
            f"of {pad_bucket(gang)} images ({2 * pad_bucket(gang)} CFG rows), flush 'gang', "
            f"trace echoed: served in {got['gang']['s']:.3f}s (job_s "
            f"{timings['gang']['job_s']}, queue_wait {timings['gang'].get('queue_wait_s')}); by "
            f"the linger {got['linger']['s']:.3f}s (job_s {timings['linger']['job_s']}, "
            f"queue_wait {timings['linger'].get('queue_wait_s')}); pixels equal bit for bit "
            f"({gang} of {gang}); the gang of {big_gang} SD 1.5 jobs as passes of 8 + 1 in "
            f"{got['big']['s']:.3f}s; first poll gang_rows {first['gang_rows']}")

        # 2. failover
        primary, standby = make_hive(), make_hive()
        primary.not_primary(epoch=2, endpoints=("results",))
        w = worker([primary.uri, standby.uri], hive_failover_errors=2)
        failed_over = failovers.value()
        before = _snapshot(counters)

        def failover(w):
            primary.enqueue(job("fo-1", sd15, size15, steps, 1600))
            _until(lambda: "fo-1" in standby.bodies, 300, "fo-1 on the standby")
            first = {"parked": [p.name for p in (root / "sdaas" / "outbox").iterdir()
                                if p.name.endswith(".parked")],
                     "epoch_file": (root / "sdaas" / "hive_epoch").read_text(),
                     "echoed": [e for p, e in standby.epochs_seen if p == "/api/results"]}
            primary.promote(epoch=2)
            standby.go_dark()
            t_dark = time.monotonic()
            primary.enqueue(job("fo-2", sd15, size15, steps, 1601))
            _until(lambda: "fo-2" in primary.bodies, 300, "fo-2 on the primary")
            status, health = _http(f"http://127.0.0.1:{w.settings.metrics_port}/healthz")
            status_m, text = _http(f"http://127.0.0.1:{w.settings.metrics_port}/metrics")
            w.stop()
            return first, t_dark, json.loads(health), _samples(text.decode())

        (first, t_dark, health, metrics), run_s = run_beside(w, failover)
        count("hive_failover_sd15", 2, before, {k: 2 * v for k, v in
                                                per_job(sd15, steps).items()})
        dark_polls = [t for t, p, _ in standby.requests
                      if p.startswith("/api/work") and t >= t_dark]
        taken = primary.handed["fo-2"]
        moved = failovers.value() - failed_over
        hive_block = health["hive"]
        check(not first["parked"] and first["epoch_file"] == "2" and "2" in first["echoed"],
              f"the 409 on /results: parked {first['parked']}, hive_epoch "
              f"{first['epoch_file']!r}, echoed {first['echoed']}")
        check(len(dark_polls) >= 2 and taken > dark_polls[0] and moved == 2
              and metrics.get(("swarm_hive_failover_total", ())) == failovers.value(),
              f"the dark standby: {len(dark_polls)} failed polls, {moved} failovers")
        check(hive_block["active_endpoint"] == f"{primary.uri}/api"
              and hive_block["failovers"] == 2 and hive_block["epoch"] == 2,
              f"/healthz hive {hive_block}")
        for job_id, h in (("fo-1", standby), ("fo-2", primary)):
            image(json.loads(h.bodies[job_id][0]))
        served["failover"] = {"dark_to_taken_s": taken - dark_polls[0],
                              "failed_polls": len(dark_polls), "health": hive_block,
                              "run_s": run_s}
        log(f"[hive] failover: fo-1 taken from the primary, its /results answered 409 with "
            f"epoch 2, delivered on the standby with X-Hive-Epoch 2 echoed, nothing parked, "
            f"hive_epoch reads {first['epoch_file']}; the standby dark: {len(dark_polls)} failed "
            f"polls, pinned back to the primary, fo-2 taken "
            f"{served['failover']['dark_to_taken_s']:.3f}s after the first failed poll "
            f"(backoff cap {backoff_cap_s}s); swarm_hive_failover_total +{moved}; /healthz hive "
            f"{json.dumps(hive_block)}")

        # 3. stage graphs
        hive = make_hive()
        w = worker([hive.uri], max_coalesce=1)

        def graphs(w):
            out = {}
            wf = {k: v for k, v in job("x", sdxl, size_xl, steps, 1700).items() if k != "id"}
            before = _snapshot(counters)
            t0 = time.monotonic()
            hive.submit_workflow(wf, "wf-xl")
            out["xl"] = hive.wait_for_workflow("wf-xl", 600)
            out["xl_s"] = hive.settled["wf-xl-s2-decode"] - t0
            count("hive_staged_sdxl", 1, before, per_job(sdxl, steps))
            before = _snapshot(counters)
            t0 = time.monotonic()
            hive.enqueue(job("mono-xl", sdxl, size_xl, steps, 1700))
            out["mono_xl"] = wait(hive, ["mono-xl"])["mono-xl"]
            out["mono_xl_s"] = hive.settled["mono-xl"] - t0
            count("hive_mono_sdxl", 1, before, per_job(sdxl, steps))

            up = {k: v for k, v in job("x", sd15, size15, steps, 1710).items() if k != "id"}
            before = _snapshot(counters)
            t0 = time.monotonic()
            hive.submit_workflow({**up, "upscale": True}, "wf-up")
            out["up"] = hive.wait_for_workflow("wf-up", 600)
            out["up_s"] = hive.settled["wf-up-s3-decode"] - t0
            count("hive_staged_sd15_upscale", 1, before, per_job(sd15, steps, upscale=True))
            hive.enqueue(job("mono-up", sd15, size15, steps, 1710, upscale=True),
                         job("mono-base", sd15, size15, steps, 1710))
            out.update(wait(hive, ["mono-up", "mono-base"]))

            # two workflows back to back: the second submitted when the
            # first's denoise is on the device
            before = _snapshot(counters)
            hive.submit_workflow(wf, "wf-a")
            _until(lambda: "wf-a-s1-denoise" in w._executing, 600, "wf-a's denoise")
            hive.submit_workflow({**wf, "seed": 1701}, "wf-b")
            for wid in ("wf-a", "wf-b"):
                out[wid] = hive.wait_for_workflow(wid, 600)
            count("hive_staged_sdxl_pair", 2, before,
                  {k: 2 * v for k, v in per_job(sdxl, steps).items()})
            _until(lambda: w._stage_depth() == 0 and not w._handoff_ids, 60, "the lane to drain")
            status, text = _http(f"http://127.0.0.1:{w.settings.metrics_port}/metrics")
            out["metrics"] = _samples(text.decode())
            w.stop()
            return out

        got, run_s = run_beside(w, graphs)
        for wid in ("xl", "up", "wf-a", "wf-b"):
            check(got[wid]["state"] == "done", f"{wid}: {got[wid]['stages']}")
        staged, mono = got["xl"]["result"], got["mono_xl"]
        staged_px, mono_px = image(staged), image(mono)
        check(staged["artifacts"]["primary"]["sha256_hash"]
              == mono["artifacts"]["primary"]["sha256_hash"]
              and np.array_equal(staged_px, mono_px),
              "the staged SDXL image differs from the monolithic job's")
        check(staged["pipeline_config"]["nsfw_checked"] is True
              and staged["pipeline_config"]["nsfw"] == mono["pipeline_config"]["nsfw"],
              f"the decode stage's check: {staged['pipeline_config']}")
        raw_ref = hive.workflows["wf-xl"]["stages"][1]["artifacts"]["raw"]
        blob = hive.artifacts[raw_ref["sha256"]]
        t0 = time.perf_counter()
        rows = unpack_raw(blob)
        unpack_ms = 1000 * (time.perf_counter() - t0)
        denoise_cfg = hive.workflows["wf-xl"]["stages"][1]["result"]["pipeline_config"]
        dt, mt = denoise_cfg["timings"], mono["pipeline_config"]["timings"]
        # the upscale workflow: the upscaler's input, then its output
        base_px = image(got["mono-base"])
        up_stages = hive.workflows["wf-up"]["stages"]
        handed = unpack_raw(hive.artifacts[up_stages[1]["artifacts"]["raw"]["sha256"]])
        check(len(handed) == 1 and np.array_equal(np.asarray(handed[0]), base_px),
              "the rows handed to the upscaler differ from the monolithic job's image")
        up_cfg = up_stages[2]["result"]["pipeline_config"]
        staged_up = image(got["up"]["result"])
        check(up_cfg.get("upscaler") is None and up_cfg["upscaled"]
              and staged_up.shape == (2 * size15, 2 * size15, 3),
              f"the upscale stage: {up_cfg}, image {staged_up.shape}")
        prompt = BATCH_PROMPTS[0]

        def direct(seed):
            gen = torch.Generator(device=device).manual_seed(int(seed))
            return np.asarray(upscaler.upscale(handed, prompt=prompt, generator=gen)[0])

        again = direct(up_cfg["seed"])
        check(np.array_equal(again, staged_up),
              "the staged upscale differs from the upscaler run on the same rows and seed")
        mono_up = image(got["mono-up"])
        spread = float(np.abs(direct(1).astype(np.int16) - direct(2).astype(np.int16)).mean())
        diff = float(np.abs(staged_up.astype(np.int16) - mono_up.astype(np.int16)).mean())
        check(mono_up.shape == staged_up.shape and diff <= UPSCALE_SPREAD_RATIO * spread,
              f"the upscale workflow against the monolithic job: mean |d| {diff:.3f} > "
              f"{UPSCALE_SPREAD_RATIO} x the two-seed spread {spread:.3f}")
        # the overlap: wf-a's decode on the lane inside wf-b's pass
        spans = {tuple(t["ids"]): t for t in w.timeline}
        decode_a, pass_b = spans[("wf-a-s2-decode",)], spans[("wf-b-s1-denoise",)]
        overlap = (min(decode_a["end"], pass_b["end"]) - max(decode_a["start"], pass_b["start"]))
        lane_busy = sum(max(0.0, min(t["end"], pass_b["end"]) - max(t["start"], pass_b["start"]))
                        for t in w.timeline if t["lane"] == "stage")
        check(decode_a["lane"] == "stage" and pass_b["lane"] == "device" and overlap > 0,
              f"wf-a's decode [{decode_a['start']:.3f}, {decode_a['end']:.3f}] and wf-b's pass "
              f"[{pass_b['start']:.3f}, {pass_b['end']:.3f}] do not overlap")
        # 4. stats and the lane's gauge
        stats = json.loads(hive.polls[-1].get("stats") or "{}").get("s", {})
        depth = got["metrics"].get(("swarm_queue_depth", (("queue", "stage"),)))
        check({"denoise", "encode", "decode", "upscale", "handoff"} <= set(stats) and depth == 0,
              f"stats {sorted(stats)}, swarm_queue_depth{{queue=stage}} {depth}")
        polled = {p.get("stages") for p in hive.polls}
        served["stages"] = {
            "raw_bytes": len(blob), "raw_rows": len(rows), "png_encode_s": dt.get("handoff_s"),
            "png_decode_ms": unpack_ms, "staged_s": got["xl_s"], "mono_s": got["mono_xl_s"],
            "staged_up_s": got["up_s"], "denoise_s": [dt["denoise_s"], mt["denoise_s"]],
            "decode_s": [dt["decode_s"], mt["decode_s"]],
            "unet_step_ms": [dt["unet_step_ms"], mt["unet_step_ms"]],
            "upscale": {"diff": diff, "spread": spread, "seed": up_cfg["seed"]},
            "overlap_s": overlap, "lane_busy_in_pass_s": lane_busy,
            "pass_s": pass_b["end"] - pass_b["start"], "stats": stats, "run_s": run_s}
        s = served["stages"]
        log(f"[hive] stage graph: wf-xl (SDXL {size_xl}^2, {steps} steps) as encode / denoise / "
            f"decode, encode and decode on the lane, the decode's checker on {nsfw.device}; the "
            f"final PNG equal bit for bit to the monolithic job's (sha256 "
            f"{staged['artifacts']['primary']['sha256_hash'][:16]}), launches equal; handoff: "
            f"{s['raw_bytes']} bytes of raw blob ({s['raw_rows']} row), PNG encode "
            f"{s['png_encode_s']}s, decode {unpack_ms:.1f} ms; staged {s['staged_s']:.3f}s "
            f"end to end against monolithic {s['mono_s']:.3f}s; denoise_s {s['denoise_s']}, "
            f"decode_s {s['decode_s']}, unet_step_ms {s['unet_step_ms']} (staged, monolithic)")
        log(f"[hive] upscale workflow (SD 1.5 {size15}^2 -> {2 * size15}^2): rows into the "
            f"upscaler equal the monolithic image bit for bit, the stage's output equals the "
            f"upscaler on them with its seed {up_cfg['seed']} bit for bit; against the "
            f"monolithic upscale job mean |d| {diff:.3f} levels, two-seed spread {spread:.3f} "
            f"(bound {UPSCALE_SPREAD_RATIO}x); end to end {s['staged_up_s']:.3f}s")
        log(f"[hive] overlap: wf-a's decode on the lane {decode_a['end'] - decode_a['start']:.3f}s,"
            f" {overlap:.3f}s of it inside wf-b's {s['pass_s']:.3f}s pass; the lane busy "
            f"{lane_busy:.3f}s inside that pass; stats stages {sorted(stats)} (denoise EWMA "
            f"{stats['denoise'][0]}s over {stats['denoise'][1]}); advertised stages {polled}; "
            f"swarm_queue_depth{{queue=stage}} {depth}")
        check(all(h.auth_failures == 0 for h in hives), "a hive refused the worker's token")
        fma = {k: n - routes[k] for k, n in FA_COUNTER.routes.items()
               if k[0] == "fma" and k[1] == torch.bfloat16 and n > routes[k]}
        check(not fma, f"bf16 attention took the FMA kernel on the hive-plane path: {fma}")
        served["routes"] = {str(k): n - routes[k] for k, n in FA_COUNTER.routes.items()
                            if n > routes[k]}
        served["served_s"] = time.perf_counter() - t_path
    finally:
        for h in hives:
            h.close()
        if saved_root is None:
            os.environ.pop("SDAAS_ROOT", None)
        else:
            os.environ["SDAAS_ROOT"] = saved_root
        shutil.rmtree(root, ignore_errors=True)
    # the shared pipelines stay with their registries; the upscaler goes
    reg._pipelines.pop((up_name, "upscaler")).release()
    del reg, upscaler
    gc.collect()
    log(f"[hive] the hive-plane path served in {served['served_s']:.1f}s")
    return paths, served


# --- Kandinsky 2.x ---

K22 = "kandinsky-community/kandinsky-2-2-decoder"
K22_PRIOR = "kandinsky-community/kandinsky-2-2-prior"
K22_CN = "kandinsky-community/kandinsky-2-2-controlnet-depth"
K21 = "kandinsky-community/kandinsky-2-1"
K21_PRIOR = "kandinsky-community/kandinsky-2-1-prior"
TINY_K21 = "test/tiny-kandinsky-2-1"
K_STEPS = 30
K_PRIOR_STEPS = 25
K_CN_SIZE = 768  # the depth ControlNet's locked canvas
K_PROMPT = "a red fox in fresh snow, 4k photo"
# words of the smoke's prompts, the pieces of the synthetic 2.1 tokenizer
K_WORDS = ("a", "red", "fox", "in", "fresh", "snow", "4k", "photo", "lighthouse", "on", "cliff",
           "at", "dusk", "blurry", "study", "robot", ",")


def k21_tokenizer_json() -> dict:
    """A synthetic fast tokenizer in XLM-R's layout (Unigram, the Replace
    normalizers, Metaspace, <s> $A </s>): the smoke's words and the
    letters as pieces, scores from a seeded generator."""
    import numpy as np

    rng = np.random.default_rng(11)
    specials = ["<s>", "<pad>", "</s>", "<unk>"]
    pieces = [[p, 0.0] for p in specials]
    for w in K_WORDS:
        pieces.append(["▁" + w, float(-rng.uniform(2, 8))])
    for c in "abcdefghijklmnopqrstuvwxyz0123456789,":
        pieces.append([c, float(-rng.uniform(8, 12))])
    pieces.append(["▁", float(-rng.uniform(3, 6))])
    return {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": [{"id": i, "content": t, "single_word": False, "lstrip": False,
                          "rstrip": False, "normalized": False, "special": True}
                         for i, t in enumerate(specials)],
        "normalizer": {"type": "Sequence", "normalizers": [
            {"type": "Replace", "pattern": {"String": "``"}, "content": '"'},
            {"type": "Replace", "pattern": {"String": "''"}, "content": '"'},
            {"type": "Replace", "pattern": {"Regex": " {2,}"}, "content": " "}]},
        "pre_tokenizer": {"type": "Metaspace", "replacement": "▁", "prepend_scheme": "always",
                          "split": True},
        "post_processor": {
            "type": "TemplateProcessing",
            "single": [{"SpecialToken": {"id": "<s>", "type_id": 0}},
                       {"Sequence": {"id": "A", "type_id": 0}},
                       {"SpecialToken": {"id": "</s>", "type_id": 0}}],
            "pair": [], "special_tokens": {
                "<s>": {"id": "<s>", "ids": [0], "tokens": ["<s>"]},
                "</s>": {"id": "</s>", "ids": [2], "tokens": ["</s>"]}}},
        "decoder": None,
        "model": {"type": "Unigram", "unk_id": 3, "vocab": pieces, "byte_fallback": False}}


def _save(module, path: Path, dtype=None, extra: dict | None = None) -> int:
    from safetensors.torch import save_file

    path.parent.mkdir(parents=True, exist_ok=True)
    state = {k: v.detach().to("cpu", dtype or v.dtype).contiguous()
             for k, v in module.state_dict().items()}
    state.update(extra or {})
    save_file(state, str(path))
    return path.stat().st_size


def write_kandinsky(pipe, model_dir: Path, dtype=None, zero_embed: bool = False) -> int:
    """A Kandinsky decoder's or prior's weights in the published diffusers
    layout, one safetensors file a folder (in `dtype`, the pipeline's
    unset): a decoder's unet/ and movq/ with the config.json fields the
    loaders read, and for 2.1 its MCLIP text_encoder/ (config.json in
    MultilingualCLIP's keys) and tokenizer/tokenizer.json
    (`k21_tokenizer_json`); a prior's prior/ with seeded clip_mean /
    clip_std and its config.json, its CLIP text_encoder/, and with
    `zero_embed` a seeded zero_image_embed.npy. -> bytes written."""
    import numpy as np

    from chiaswarm_tpu_torch.pipelines.kandinsky import KandinskyPipeline

    def config(folder: str, payload: dict) -> None:
        (model_dir / folder).mkdir(parents=True, exist_ok=True)
        (model_dir / folder / "config.json").write_text(json.dumps(payload))

    nbytes = 0
    if isinstance(pipe, KandinskyPipeline):
        u, m = pipe.unet_cfg, pipe.movq_cfg
        nbytes += _save(pipe.unet, model_dir / "unet" / "diffusion_pytorch_model.safetensors",
                        dtype)
        config("unet", {"attention_head_dim": u.attention_head_dim,
                        "norm_num_groups": u.norm_num_groups})
        nbytes += _save(pipe.movq, model_dir / "movq" / "diffusion_pytorch_model.safetensors",
                        dtype)
        config("movq", {"block_out_channels": list(m.block_out_channels),
                        "layers_per_block": m.layers_per_block,
                        "latent_channels": m.latent_channels, "vq_embed_dim": m.vq_embed_dim,
                        "norm_num_groups": m.norm_num_groups, "norm_type": "spatial"})
        if pipe.mclip is not None:
            c = pipe.mclip.config
            nbytes += _save(pipe.mclip, model_dir / "text_encoder" / "model.safetensors", dtype)
            config("text_encoder", {
                "vocab_size": c.vocab_size, "transformerDimensions": c.hidden_size,
                "numDims": c.projection_dim, "num_hidden_layers": c.num_layers,
                "num_attention_heads": c.num_heads, "intermediate_size": c.intermediate_size,
                "max_position_embeddings": c.max_positions, "layer_norm_eps": c.layer_norm_eps})
            (model_dir / "tokenizer").mkdir(parents=True, exist_ok=True)
            (model_dir / "tokenizer" / "tokenizer.json").write_text(
                json.dumps(k21_tokenizer_json()))
            (model_dir / "tokenizer" / "tokenizer_config.json").write_text(json.dumps(
                {"tokenizer_class": "XLMRobertaTokenizer", "pad_token": "<pad>"}))
        return nbytes
    c = pipe.config
    gen = torch.Generator().manual_seed(19)
    stats = {"clip_mean": 0.1 * torch.randn((1, c.embed_dim), generator=gen),
             "clip_std": 0.5 + torch.rand((1, c.embed_dim), generator=gen)}
    nbytes += _save(pipe.prior, model_dir / "prior" / "diffusion_pytorch_model.safetensors",
                    dtype, {k: v.to(dtype or torch.float32) for k, v in stats.items()})
    config("prior", {"embedding_dim": c.embed_dim, "num_attention_heads": c.num_heads,
                     "attention_head_dim": c.head_dim, "num_layers": c.num_layers})
    nbytes += _save(pipe.text_encoder, model_dir / "text_encoder" / "model.safetensors", dtype)
    if zero_embed:
        np.save(model_dir / "zero_image_embed.npy",
                torch.randn((1, c.embed_dim), generator=gen).numpy())
    return nbytes


def seeded_decoder(name: str, device, dtype, unet_cfg=None, seed: int = 0, movq_cfg=None,
                   mclip_cfg=None):
    """A KandinskyPipeline on seeded random weights: the name's geometry, or
    `unet_cfg` with `movq_cfg` (the name's unset) and, for a text_image
    config, MCLIP at `mclip_cfg` (the tiny one beside a tiny MoVQ, else
    XLM-R large)."""
    from chiaswarm_tpu_torch.models import configs as cfgs
    from chiaswarm_tpu_torch.models.mclip import MCLIPTextEncoder
    from chiaswarm_tpu_torch.models.movq import MoVQ
    from chiaswarm_tpu_torch.models.unet_kandinsky import K22UNet
    from chiaswarm_tpu_torch.pipelines.kandinsky import KandinskyPipeline, decoder_configs
    from chiaswarm_tpu_torch.weights import random_init_

    if unet_cfg is None:
        return KandinskyPipeline(name, device=device, dtype=dtype, allow_random_init=True)
    movq_cfg = movq_cfg or decoder_configs(name)[1]
    mclip_cfg = mclip_cfg or (cfgs.TINY_MCLIP if movq_cfg == cfgs.TINY_MOVQ
                              else cfgs.MCLIP_XLMR_LARGE)
    gen = torch.Generator(device=device).manual_seed(seed)
    weights = {"unet_cfg": unet_cfg, "movq_cfg": movq_cfg}
    for key, factory in (("unet", lambda: K22UNet(unet_cfg)), ("movq", lambda: MoVQ(movq_cfg)),
                         ("mclip", lambda: MCLIPTextEncoder(mclip_cfg))):
        if key == "mclip" and unet_cfg.conditioning != "text_image":
            continue
        with torch.device("meta"):
            module = factory()
        module = module.to(dtype).to_empty(device=device)
        random_init_(module, gen)
        weights[key] = module.state_dict()
    if unet_cfg.conditioning == "text_image":
        from chiaswarm_tpu_torch.models.tokenizer import FastTokenizer

        weights.update(mclip_cfg=mclip_cfg, tokenizer=FastTokenizer(k21_tokenizer_json(),
                                                                    "<pad>"))
    return KandinskyPipeline(name, device=device, dtype=dtype, weights=weights)


def _noise(seed: int):
    """A deterministic draw (i, shape) -> f32 CPU tensor, the same for the
    card and the CPU (their generators draw different numbers)."""
    def draw(i, shape):
        return torch.randn(tuple(shape), generator=torch.Generator().manual_seed(seed * 1000 + i))
    return draw


def kandinsky_inputs(pipe, n: int, size: int, seed: int = 3, given: bool = False) -> dict:
    """Every draw of a Kandinsky job, injected: the prior's (guided and the
    unguided negative) and the decoder's; with `given` the image embeddings
    themselves (split-embeds)."""
    lat = size // pipe.latent_factor
    draws = {"latents": _noise(seed)(999, (n, pipe.latent_channels, lat, lat)),
             "noise_fn": _noise(seed + 1)}
    if given:
        e = pipe.unet_cfg.image_embed_dim if pipe.text_image else pipe.unet_cfg.encoder_hid_dim
        draws.update(image_embeds=_noise(seed + 2)(0, (n, e)),
                     negative_image_embeds=_noise(seed + 2)(1, (n, e)))
        return draws
    from chiaswarm_tpu_torch.pipelines.kandinsky import prior_configs, prior_name_for

    e = prior_configs(prior_name_for(pipe.model_name))[0].embed_dim
    draws.update(prior_latents=_noise(seed + 3)(999, (n, e)), prior_noise_fn=_noise(seed + 4),
                 prior_negative_latents=_noise(seed + 5)(999, (n, e)),
                 prior_negative_noise_fn=_noise(seed + 6))
    return draws


def tiny_kandinsky_checks(device: str = "cuda", size: int = 64, steps: int = 4) -> dict:
    """Phase 4 for Kandinsky: the tiny 2.2 decoder (txt2img, img2img at
    strength 0.5), the tiny depth ControlNet (a 768^2 hint) and their tiny
    prior (clip stats, no zero embed: the unguided negative run), and a
    tiny 2.1 decoder (MCLIP, its tokenizer.json; split embeds), seeded,
    written as diffusers safetensors under a temporary model root and
    loaded from there in f32 on `device` (the kernels on the card) and on
    the CPU (plain versions) with every draw injected alike: the uint8
    images within 2/255. -> {job: max pixel diff}."""
    import tempfile

    import numpy as np

    from chiaswarm_tpu_torch.models import configs as cfgs
    from chiaswarm_tpu_torch.pipelines.kandinsky import KandinskyPipeline, KandinskyPriorPipeline
    from chiaswarm_tpu_torch.registry import Registry

    out = {}
    with tempfile.TemporaryDirectory() as root:
        root = Path(root)
        write_kandinsky(seeded_decoder("test/tiny-kandinsky", "cpu", torch.float32),
                        root / "test/tiny-kandinsky")
        write_kandinsky(seeded_decoder("test/tiny-kandinsky-controlnet", "cpu", torch.float32),
                        root / "test/tiny-kandinsky-controlnet")
        write_kandinsky(KandinskyPriorPipeline("test/tiny-kandinsky-prior", device="cpu"),
                        root / "test/tiny-kandinsky-prior")
        write_kandinsky(seeded_decoder(TINY_K21, "cpu", torch.float32, cfgs.TINY_K21_UNET,
                                       seed=4), root / TINY_K21)
        regs = {}
        for d in ("cpu", device):
            # f32 on both: the pipelines are built here, not by the registry
            regs[d] = Registry(torch.device(d), str(root), safety_checker_model="")
            regs[d]._pipelines[("test/tiny-kandinsky-prior", "kandinsky_prior")] = (
                KandinskyPriorPipeline("test/tiny-kandinsky-prior", device=d,
                                       dtype=torch.float32, model_root_dir=str(root)))
        hint = np.asarray(photo_image(K_CN_SIZE), np.float32)[..., :1].repeat(3, -1) / 255.0
        jobs = {"txt2img": ("test/tiny-kandinsky", {}, False),
                "img2img": ("test/tiny-kandinsky", {"image": start_image(size),
                                                    "strength": 0.5}, False),
                "controlnet": ("test/tiny-kandinsky-controlnet", {
                    "hint": hint, "pipeline_type": "KandinskyV22ControlnetPipeline"}, False),
                "k21": (TINY_K21, {"pipeline_type": "KandinskyPipeline"}, True)}
        for job, (model, extra, given) in jobs.items():
            images = {}
            for d, reg in regs.items():
                pipe = KandinskyPipeline(model, device=d, dtype=torch.float32,
                                         model_root_dir=str(root))
                check(pipe.weights_source == "checkpoint", f"{model} on {d}: {pipe.weights_source}")
                images[d], config = pipe.run(
                    K_PROMPT, "blurry", num_inference_steps=steps, prior_timesteps=3,
                    height=size, width=size, num_images_per_prompt=2, registry=reg,
                    **extra, **kandinsky_inputs(pipe, 2, size, given=given))
            diff = max(int(np.abs(g.astype(np.int16) - w.astype(np.int16)).max())
                       for g, w in zip(images[device], images["cpu"]))
            log(f"[tiny] Kandinsky {job} ({model}, {size}^2 f32, {steps} steps, "
                f"{config['conditioning']}, mode {config['mode']}), card (kernels) vs CPU "
                f"(plain): max pixel diff {diff}/255 (bound 2/255)")
            check(diff <= 2, f"Kandinsky {job}: card vs CPU pixel diff {diff} > 2")
            out[job] = diff
    return out


def k_unet_calls(cfg, side: int, rows: int = 2, dtype=torch.bfloat16) -> dict:
    """Every kernel call of one Kandinsky decoder UNet call on a side^2
    latent with `rows` CFG rows, from the config, under the wrappers' own
    counter keys -> {"flash_attention": Counter, "group_norm": Counter}.
    Each resnet norms its input (SiLU fused) and its output (none fused),
    both at eps 1e-5; a downsampler or upsampler is a resnet that halves or
    doubles the side between the two. Each attention norms its [B, S, C]
    tokens and attends S queries over the conditioning tokens (the image
    tokens, and for 2.1 MCLIP's 77 states after them) ahead of the S self
    keys, at D = attention_head_dim. A down level: layers_per_block
    resnets, each followed by an attention where the level attends, then
    a downsampler but at the last level; the mid block: resnet, attention,
    resnet; an up level: one resnet more, each on a skip concatenated,
    then an upsampler but at the first level; last the output norm with
    SiLU."""
    from chiaswarm_tpu_torch.pipelines.kandinsky import MCLIP_MAX_LENGTH

    calls = {"flash_attention": Counter(), "group_norm": Counter()}
    dt = str(dtype).replace("torch.", "")
    tokens = cfg.image_proj_tokens + (MCLIP_MAX_LENGTH if cfg.conditioning == "text_image"
                                      else 0)

    def resnet(c_in, c_out, s, s_out=None):
        calls["group_norm"][((rows, s, s, c_in), dt, True, 1e-5)] += 1
        s_out = s_out or s
        calls["group_norm"][((rows, s_out, s_out, c_out), dt, False, 1e-5)] += 1

    def attention(c, s):
        d = cfg.attention_head_dim
        calls["group_norm"][((rows, s * s, c), dt, False, 1e-5)] += 1
        calls["flash_attention"][((rows, s * s, c // d, d),
                                  (rows, tokens + s * s, c // d, d), dtype)] += 1

    chans, n = cfg.block_out_channels, cfg.layers_per_block
    ch, skips = chans[0], [chans[0]]
    for level, out in enumerate(chans):
        s = side >> level
        for _ in range(n):
            resnet(ch, out, s)
            if cfg.down_attention[level]:
                attention(out, s)
            ch = out
            skips.append(out)
        if level < len(chans) - 1:
            resnet(out, out, s, s // 2)
            skips.append(out)
    s = side >> (len(chans) - 1)
    resnet(ch, ch, s)
    attention(ch, s)
    resnet(ch, ch, s)
    for level in reversed(range(len(chans))):
        out, s = chans[level], side >> level
        for _ in range(n + 1):
            resnet(ch + skips.pop(), out, s)
            if cfg.down_attention[level]:
                attention(out, s)
            ch = out
        if level:
            resnet(out, out, s, 2 * s)
    calls["group_norm"][((rows, side, side, chans[0]), dt, True, 1e-5)] += 1
    return calls


def movq_calls(cfg, size: int, part: str, dtype=torch.bfloat16) -> dict:
    """Every kernel call of one MoVQ `part` ("decode" of one latent, or
    "encode" of one size^2 image), from the config, under the wrappers'
    counter keys. Every norm is at eps 1e-6. The encoder: layers_per_block
    resnets a level (two norms each, SiLU fused), a stride-2 conv between
    levels, the mid block (resnet, attention with its norm, resnet) and the
    output norm with SiLU. The decoder: the mid block at the latent side,
    layers_per_block + 1 resnets a level up the reversed widths, a nearest
    2x between levels, the output norm, every norm a SpatialNorm (its SiLU
    outside the kernel). The mid attention is one head of the widest
    level's channels."""
    calls = {"flash_attention": Counter(), "group_norm": Counter()}
    dt = str(dtype).replace("torch.", "")
    chans, n, levels = cfg.block_out_channels, cfg.layers_per_block, len(cfg.block_out_channels)
    # the encoder's GroupNorms fuse their SiLU; SpatialNorm applies it after
    # its modulation, outside the kernel
    silu = part == "encode"

    def resnet(c_in, c_out, s):
        calls["group_norm"][((1, s, s, c_in), dt, silu, 1e-6)] += 1
        calls["group_norm"][((1, s, s, c_out), dt, silu, 1e-6)] += 1

    def mid(c, s):
        resnet(c, c, s)
        calls["group_norm"][((1, s, s, c), dt, False, 1e-6)] += 1
        calls["flash_attention"][((1, s * s, 1, c), (1, s * s, 1, c), dtype)] += 1
        resnet(c, c, s)

    if part == "encode":
        ch = chans[0]
        for level, out in enumerate(chans):
            for _ in range(n):
                resnet(ch, out, size >> level)
                ch = out
        mid(ch, size >> (levels - 1))
        calls["group_norm"][((1, size >> (levels - 1), size >> (levels - 1), ch), dt, True,
                             1e-6)] += 1
        return calls
    rev = tuple(reversed(chans))
    side = size >> (levels - 1)
    mid(rev[0], side)
    ch = rev[0]
    for b, out in enumerate(rev):
        for _ in range(n + 1):
            resnet(ch, out, side << b)
            ch = out
    calls["group_norm"][((1, size, size, ch), dt, False, 1e-6)] += 1
    return calls


def kandinsky_calls(unet_cfg, movq_cfg, size: int, rows: int = 2,
                    dtype=torch.bfloat16) -> dict:
    """Every kernel call, by its counter key, of one decoder UNet call with
    `rows` CFG rows at size^2, one MoVQ decode and one MoVQ encode of an
    image, from the configs -> {"unet" | "decode" | "encode": {kernel:
    Counter}}."""
    side = size // 2 ** (len(movq_cfg.block_out_channels) - 1)
    return {"unet": k_unet_calls(unet_cfg, side, rows, dtype),
            "decode": movq_calls(movq_cfg, size, "decode", dtype),
            "encode": movq_calls(movq_cfg, size, "encode", dtype)}


def _launches(calls: dict) -> dict:
    return {k: sum(v.values()) for k, v in calls.items()}


def kandinsky_checks(gen) -> None:
    """Phase 3 at Kandinsky's shapes, in bf16 and f32: every attention and
    GroupNorm call of a 2.2 and a 2.1 decoder UNet call (two CFG rows; the
    keys are the 32 or 10 + 77 conditioning tokens ahead of the self
    tokens, lengths that are no tile multiple) and of a MoVQ decode and
    encode (its one head of D = 512, its norms at eps 1e-6 up to
    [1, 768, 768, 128]), at 512^2 and 768^2. Each bf16 attention call must
    report the tensor-core route (wgmma-d64, wgmma-d512)."""
    from chiaswarm_tpu_torch.models import configs as cfgs

    attention, norms = Counter(), {}
    for unet_cfg in (cfgs.K22_DECODER_UNET, cfgs.K21_DECODER_UNET):
        for size in (512, 768):
            for part in kandinsky_calls(unet_cfg, cfgs.MoVQConfig(), size).values():
                attention.update(part["flash_attention"])
                norms.update(dict.fromkeys(part["group_norm"]))
    for q_shape, k_shape, _ in attention:
        for dtype in (torch.bfloat16, torch.float32):
            row = attention_case(q_shape, k_shape, dtype, gen, timed=False)
            log(f"[check] flash_attention q{q_shape} kv{k_shape} {row['dtype']} route "
                f"{row['route']} (Kandinsky): max_abs_err {row['max_abs_err']:.3g}"
                + (f", RMS err {row['rms_err']:.3g}" if "rms_err" in row else "")
                + f" (bound {row['bound']})")
            torch.cuda.empty_cache()
    for x_shape, _, silu, eps in norms:
        for dtype in (torch.bfloat16, torch.float32):
            row = gn_case(x_shape, dtype, silu, gen, timed=False, eps=eps)
            log(f"[check] group_norm x{x_shape} {row['dtype']} silu={silu} eps {eps:g} "
                f"(Kandinsky): max_abs_err {row['max_abs_err']:.3g} (bound {row['bound']})"
                + (f", on chip: {row['on_chip']}" if "on_chip" in row else ""))
    torch.cuda.empty_cache()


def k_job(job_id: str, model: str, size: int, seed: int, pipeline_type: str,
          workflow: str = "txt2img", steps: int = K_STEPS, prior_steps: int = K_PRIOR_STEPS,
          **extra) -> dict:
    """A Kandinsky job as the hive sends it: 30 decoder steps on DDPM at
    guidance 4.0, the prior's 25 (unset)."""
    params = {"pipeline_type": pipeline_type, "scheduler_type": "DDPMScheduler",
              "prior_timesteps": prior_steps, **extra.pop("parameters", {})}
    return {"id": job_id, "workflow": workflow, "model_name": model,
            "prompt": f"{K_PROMPT}, study {seed}", "negative_prompt": "blurry",
            "height": size, "width": size, "num_inference_steps": steps,
            "guidance_scale": 4.0, "seed": seed, "content_type": "image/png",
            "parameters": params, **extra}


def serve_kandinsky_path(smi: str, device: str = "cuda", dtype=None, sizes=(512, 768),
                         steps: int = K_STEPS, prior_steps: int = K_PRIOR_STEPS,
                         hold: bool = True, tiny: bool = False,
                         profile: bool = True) -> tuple[dict, dict]:
    """Phase 5, the Kandinsky path, in a registry of its own beside the
    main path's resident SDXL pipelines: full-width seeded models written
    as diffusers safetensors (bf16) under a temporary root and loaded from
    there, one at a time and each folder removed once its pipeline is
    resident: the 2.2 prior (with zero_image_embed.npy) and decoder, the
    bytes allocated before, with both built and after they are released
    printed (the resident bytes the registry reckons beside them); 2.2
    txt2img at 512^2 and 768^2, img2img at strength 0.75; the depth
    ControlNet decoder at 768^2, its hint built by the port's DPT from
    seeded weights; then 2.1's prior (no zero embed: the unguided negative
    run) and decoder (MCLIP, the synthetic tokenizer.json) at 512^2. Every
    job through the worker and the fake hive, its envelope checked
    (sha256, decodable, not constant, finite latents) and its launches
    held, in total and shape by shape, to the prediction from the configs
    (`kandinsky_calls`: UNet calls x a call's launches, a decode, an
    encode for img2img, the DPT's for the hint). Prints prior_s, text_encode_s, denoise_s, decode_s and the
    UNet step, and profiles one decoder UNet call and one MoVQ decode. ->
    ({job kind: (1, {kernel: (launches, {shape: launches})})}, served).
    `tiny` runs the same path on the tiny stand-ins (a CPU rehearsal; the
    ControlNet job names the production model with `test_tiny_model`, as
    only that name gets a hint)."""
    import gc
    import shutil
    import tempfile

    import numpy as np

    from chiaswarm_tpu_torch.capacity import resident_bytes
    from chiaswarm_tpu_torch.models import configs as cfgs
    from chiaswarm_tpu_torch.pipelines.kandinsky import KandinskyPriorPipeline
    from chiaswarm_tpu_torch.registry import Registry

    dtype = dtype or (torch.bfloat16 if device == "cuda" else torch.float32)
    names = ({"k22": "test/tiny-kandinsky", "k22_prior": "test/tiny-kandinsky-prior",
              "cn": "test/tiny-kandinsky-controlnet", "k21": TINY_K21}
             if tiny else {"k22": K22, "k22_prior": K22_PRIOR, "cn": K22_CN, "k21": K21,
                           "k21_prior": K21_PRIOR})
    root = Path(tempfile.mkdtemp(prefix="kandinsky-models-"))
    served, paths = {"jobs": {}, "allocated_gib_before": _allocated_gib(device)}, {}
    registry = Registry(torch.device(device), str(root), safety_checker_model="")

    def write(key, pipe, **kw) -> None:
        t0 = time.perf_counter()
        nbytes = write_kandinsky(pipe, root / names[key], dtype=dtype, **kw)
        served.setdefault("written", {})[names[key]] = {"bytes": nbytes,
                                                        "s": time.perf_counter() - t0}
        log(f"[kandinsky] {names[key]} written: {nbytes / 2**30:.2f} GiB in "
            f"{time.perf_counter() - t0:.1f}s")

    def build(key, pipeline_type):
        t0 = time.perf_counter()
        pipe = registry.get_pipeline(names[key], pipeline_type=pipeline_type)
        check(pipe.weights_source == "checkpoint", f"{names[key]}: {pipe.weights_source}")
        shutil.rmtree(root / names[key])  # resident now: its files are not read again
        log(f"[kandinsky] {names[key]} resident in {time.perf_counter() - t0:.1f}s from "
            f"{pipe.checkpoint['bytes'] / 2**30:.2f} GiB of safetensors")
        return pipe

    def serve(kind, jobs, files=None, settings_kw=None, detector=None):
        results, launches, wall = serve_group(registry, jobs, device, max_coalesce=1,
                                              files=files, settings_kw=settings_kw)
        for job in jobs:
            r = results[job["id"]]
            cfg = r["pipeline_config"]
            check(not r.get("fatal_error") and "error" not in cfg, f"{job['id']}: {cfg}")
            image = decode_artifact(r["artifacts"]["primary"])
            size = job["height"]
            check(image.shape == (size, size, 3), f"{job['id']}: image {image.shape}")
            check(int(image.max()) != int(image.min()), f"{job['id']}: constant image")
            check(cfg["latents"]["finite"], f"{job['id']}: non-finite latents")
            pipe = registry.get_pipeline(cfg["model"], pipeline_type="KandinskyV22Pipeline")
            calls = kandinsky_calls(pipe.unet_cfg, pipe.movq_cfg, size, dtype=dtype)
            unet_calls = cfg["steps"] - (int(cfg["steps"] * 0.25)
                                         if job["workflow"] == "img2img" else 0)
            per = {k: _launches(v) for k, v in calls.items()}
            shapes = {}
            for k, unet_shapes in calls["unet"].items():
                shapes[k] = Counter({key: unet_calls * n for key, n in unet_shapes.items()})
                shapes[k].update(calls["decode"][k])
                if job["workflow"] == "img2img":
                    shapes[k].update(calls["encode"][k])
            if detector:
                shapes["flash_attention"][(*DPT_ATTENTION, dtype)] += detector["flash_attention"]
            predicted = {k: sum(v.values()) for k, v in shapes.items()}
            counted = {k: v[0] for k, v in launches.items()}
            t = cfg["timings"]
            log(f"[kandinsky] {job['id']} ({cfg['model']}, {cfg['conditioning']}, {size}^2, "
                f"mode {cfg['mode']}, {cfg['steps']} steps on {cfg['scheduler']}) on {smi}: job "
                f"{t['job_s']:.3f}s = prior {t.get('prior_s', 0):.3f}s (text_encode "
                f"{t.get('text_encode_s', 0):.3f}s) + denoise {t['denoise_s']:.3f}s (UNet step "
                f"{t['unet_step_ms']:.1f} ms) + decode {t['decode_s']:.3f}s"
                + (f" + encode {t['encode_s']:.3f}s" if "encode_s" in t else "")
                + f"; launches counted {json.dumps(counted)}, predicted {json.dumps(predicted)}"
                f" ({unet_calls} UNet calls x {json.dumps(per['unet'])} + decode "
                f"{json.dumps(per['decode'])}); pixels {int(image.min())}..{int(image.max())}")
            if hold:
                check(counted == predicted, f"{job['id']}: launches {counted} != {predicted}")
                for k, want in shapes.items():
                    got = Counter({(tuple(key[0]), tuple(key[1]), *key[2:])
                                   if k == "flash_attention" else (tuple(key[0]), *key[1:]): n
                                   for key, n in launches[k][1].items()})
                    check(got == want, f"{job['id']}: {k} launches by shape differ from the "
                          f"configs' (counted less predicted {dict(got - want)}, predicted "
                          f"less counted {dict(want - got)})")
                for name, count in counted.items():
                    check(count > 0, f"{name} was never launched on the Kandinsky path")
            served["jobs"][job["id"]] = {
                "timings": t, "launches": counted, "predicted": predicted,
                "latents": cfg["latents"], "wall_s": wall,
                "pixels_sha256": hashlib.sha256(image.tobytes()).hexdigest()}
        paths[kind] = (len(jobs), launches)

    k22_size, cn_size = (64, 64) if tiny else (512, K_CN_SIZE)
    job_kw = {"steps": steps, "prior_steps": prior_steps}
    write("k22_prior", KandinskyPriorPipeline(names["k22_prior"], device=device, dtype=dtype,
                                              allow_random_init=True), zero_embed=True)
    gc.collect()
    write("k22", seeded_decoder(names["k22"], device, dtype))
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    before = _allocated_gib(device)
    prior = build("k22_prior", "KandinskyV22PriorPipeline")
    decoder = build("k22", "KandinskyV22Pipeline")
    built = _allocated_gib(device)
    served["bundle"] = {
        "allocated_gib_before": before, "allocated_gib_built": built,
        "pair_gib": built - before,
        "params_gib": {name: sum(p.numel() * p.element_size() for m in mods
                                 for p in m.parameters()) / 2**30
                       for name, mods in ((names["k22"], (decoder.unet, decoder.movq)),
                                          (names["k22_prior"],
                                           (prior.prior, prior.text_encoder)))},
        "reckoned_gib": {n: resident_bytes(device, n) / 2**30
                         for n in (names["k22"], names["k22_prior"])}}
    log(f"[kandinsky] the 2.2 pair beside {before:.2f} GiB allocated: "
        f"{served['bundle']['pair_gib']:.2f} GiB allocated by it "
        f"(parameters {json.dumps({k: round(v, 3) for k, v in served['bundle']['params_gib'].items()})}"
        f" GiB; capacity.resident_bytes reckons "
        f"{json.dumps({k: round(v, 3) for k, v in served['bundle']['reckoned_gib'].items()})} GiB "
        "with one image)")
    del prior, decoder
    sizes = (64,) if tiny else sizes
    for size in sizes:
        serve(f"k22_txt2img_{size}", [k_job(f"k22-{size}", names["k22"], size, 5100 + size,
                                            "KandinskyV22Pipeline", **job_kw)])
    serve("k22_img2img", [k_job("k22-img2img", names["k22"], k22_size, 5201,
                                "KandinskyV22Img2ImgPipeline", workflow="img2img",
                                start_image_uri="start", strength=0.75, **job_kw)],
          files={"start": image_bytes(start_image(k22_size), "JPEG")})
    if profile and device == "cuda":
        pipe = registry.get_pipeline(names["k22"], pipeline_type="KandinskyV22Pipeline")
        x, t, cond = kandinsky_unet_inputs(pipe, 512)
        z = torch.randn((1, 4, 64, 64), device=device, dtype=dtype)
        served["profile"] = profile_fns(names["k22"], 512, 2, {
            "unet": (lambda: pipe.unet(x, t, cond), 3),
            "movq_decode": (lambda: pipe.movq.decode(z), 2)}, pipe.device)
        log_profile(served["profile"], smi)
        check_one_launch_per_call(served["profile"])
        del pipe, x, t, cond, z
    # the depth ControlNet: the port's DPT builds the hint from the job's image
    write_detectors(root, 5, tiny=tiny, depth_model="test/tiny-dpt" if tiny else DPT_MODEL,
                    skip=("hed", "pose", "pidinet", "mlsd", "lineart", "zoe", "upernet"))
    write("cn", seeded_decoder(names["cn"], device, dtype, seed=1))
    gc.collect()
    build("cn", "KandinskyV22ControlnetPipeline")
    cn_kw = {"test_tiny_model": True} if tiny else {}
    serve("k22_controlnet", [k_job("k22-controlnet", K22_CN, cn_size, 5301,
                                   "KandinskyV22ControlnetPipeline", parameters={
                                       "controlnet": {"control_image_uri": "photo"}, **cn_kw},
                                   **job_kw)],
          files={"photo": image_bytes(photo_image(cn_size), "JPEG")},
          settings_kw={"depth_model": "test/tiny-dpt" if tiny else DPT_MODEL},
          detector=DPT_LAUNCHES if not tiny else None)
    # 2.1: its prior without a zero embed, its decoder on MCLIP
    if not tiny:
        write("k21_prior", KandinskyPriorPipeline(names["k21_prior"], device=device,
                                                  dtype=dtype, allow_random_init=True))
        gc.collect()
    write("k21", seeded_decoder(names["k21"], device, dtype,
                                cfgs.TINY_K21_UNET if tiny else cfgs.K21_DECODER_UNET, seed=2))
    gc.collect()
    k21 = build("k21", "KandinskyPipeline")
    served["bundle_21"] = {
        "params_gib": sum(p.numel() * p.element_size() for m in (k21.unet, k21.movq, k21.mclip)
                          for p in m.parameters()) / 2**30,
        "reckoned_gib": resident_bytes(device, names["k21"]) / 2**30}
    del k21
    log(f"[kandinsky] the 2.1 decoder (UNet, MoVQ, MCLIP): parameters "
        f"{served['bundle_21']['params_gib']:.3f} GiB; capacity.resident_bytes reckons "
        f"{served['bundle_21']['reckoned_gib']:.3f} GiB with one image")
    if not tiny:
        build("k21_prior", "KandinskyV22PriorPipeline")
    serve("k21_txt2img", [k_job("k21-512", names["k21"], k22_size, 5401, "KandinskyPipeline",
                                **job_kw)])
    served["resident_after"] = registry.resident_models()
    del registry
    # the hint's DPT stays process-resident otherwise
    from chiaswarm_tpu_torch.pipelines import aux_models

    aux_models.clear()
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    shutil.rmtree(root, ignore_errors=True)
    served["allocated_gib_after"] = _allocated_gib(device)
    log(f"[kandinsky] path done: {served['allocated_gib_after']:.2f} GiB allocated after "
        f"({served['allocated_gib_before']:.2f} before)")
    if device == "cuda":
        check(served["allocated_gib_after"] <= served["allocated_gib_before"] + 0.5,
              f"the Kandinsky path left {served['allocated_gib_after']:.2f} GiB allocated")
    return paths, served


def kandinsky_unet_inputs(pipe, size: int, rows: int = 2, seed: int = 7):
    """(x, t, cond) for one decoder UNet call at size^2 with `rows` rows."""
    dev, cfg = pipe.device, pipe.unet_cfg
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(pipe.dtype)

    lat = size // pipe.latent_factor
    x = randn(rows, cfg.in_channels, lat, lat).contiguous(memory_format=torch.channels_last)
    t = torch.full((rows,), 500.0, device=dev)
    if cfg.conditioning == "text_image":
        cond = {"text_states": randn(rows, 77, cfg.encoder_hid_dim),
                "text_embeds": randn(rows, cfg.cross_attention_dim),
                "image_embeds": randn(rows, cfg.image_embed_dim)}
    else:
        cond = randn(rows, cfg.encoder_hid_dim)
    return x, t, cond


# --- Kandinsky 3 and Stable Cascade ---

K3 = "kandinsky-community/kandinsky-3"
CASCADE_PRIOR = "stabilityai/stable-cascade-prior"
CASCADE = "stabilityai/stable-cascade"
K3_STEPS = 25  # Kandinsky3Pipeline's defaults: 25 DDPM steps at guidance 3.0
K3_GUIDANCE = 3.0
CASCADE_PRIOR_STEPS = 20
CASCADE_DECODER_STEPS = 10
# the published stage C's conditioning tokens: 77 CLIP states, then the
# image embedding and the pooled text, each mapped to clip_seq tokens
CASCADE_TEXT_TOKENS = 77


def k3_unet_calls(cfg, side: int, rows: int = 2, dtype=torch.bfloat16) -> dict:
    """Every kernel call of one Kandinsky 3 UNet call on a side^2 latent with
    `rows` CFG rows, from the config: its conditional group norms and its
    attention are plain (as in JAX), so the output norm is the one call,
    GroupNorm at the first level's width (init_channels) with SiLU, eps
    1e-5."""
    dt = str(dtype).replace("torch.", "")
    return {"flash_attention": Counter(),
            "group_norm": Counter({((rows, side, side, cfg.init_channels), dt, True, 1e-5): 1})}


def cascade_unet_calls(cfg, side: int, rows: int, clip_tokens: int,
                       dtype=torch.bfloat16) -> dict:
    """Every kernel call of one Stable Cascade UNet call on a side^2 latent
    with `rows` rows, from the config: an attention block attends the
    level's tokens over those tokens followed by `clip_tokens` mapped
    conditioning tokens, at D = width / heads, once a layer of a level that
    attends, for each of its repeats; a strided level (stage B) halves the
    side, a switch level (stage C) halves it only where it says so. No
    GroupNorm: the family's norms are LayerNorms."""
    calls = {"flash_attention": Counter(), "group_norm": Counter()}
    levels = len(cfg.block_out_channels)
    s = side // cfg.patch_size
    sides = []
    for i in range(levels):
        if i and (cfg.switch_level is None or cfg.switch_level[i - 1]):
            s //= 2
        sides.append(s)
    for i in range(levels):
        if not cfg.attention[i]:
            continue
        c, h = cfg.block_out_channels[i], cfg.num_attention_heads[i]
        n = sides[i] * sides[i]
        keys = (n if cfg.self_attn else 0) + clip_tokens
        j = levels - 1 - i
        count = (cfg.down_num_layers_per_block[i] * cfg.down_blocks_repeat_mappers[i]
                 + cfg.up_num_layers_per_block[j] * cfg.up_blocks_repeat_mappers[j])
        calls["flash_attention"][((rows, n, h, c // h), (rows, keys, h, c // h), dtype)] += count
    return calls


def k3_calls(unet_cfg, movq_cfg, size: int, rows: int = 2, dtype=torch.bfloat16) -> dict:
    """{"unet" | "decode" | "encode": {kernel: Counter}} of a Kandinsky 3 job
    at size^2."""
    side = size // 2 ** (len(movq_cfg.block_out_channels) - 1)
    return {"unet": k3_unet_calls(unet_cfg, side, rows, dtype),
            "decode": movq_calls(movq_cfg, size, "decode", dtype),
            "encode": movq_calls(movq_cfg, size, "encode", dtype)}


def cascade_calls(prior_cfg, decoder_cfg, size: int, dtype=torch.bfloat16,
                  tiny: bool = False) -> dict:
    """{"prior" | "decoder": {kernel: Counter}} of one stage C call (two CFG
    rows on its grid, with the text states, the image embedding and the
    pooled text as conditioning) and one stage B call (one row, the pooled
    text alone) of a size^2 job."""
    import math

    from chiaswarm_tpu_torch.pipelines.cascade import LATENT_DIM_SCALE, PRIOR_COMPRESSION

    grid = max(4, math.ceil(size / (8.0 if tiny else PRIOR_COMPRESSION)))
    latent = 2 * (int(grid * (2.0 if tiny else LATENT_DIM_SCALE)) // 2)
    text = CASCADE_TEXT_TOKENS + prior_cfg.clip_seq * 2
    return {"prior": cascade_unet_calls(prior_cfg, grid, 2, text, dtype),
            "decoder": cascade_unet_calls(decoder_cfg, latent, 1, decoder_cfg.clip_seq, dtype)}


def kandinsky3_checks(gen) -> None:
    """Phase 3 at Kandinsky 3's shapes, in bf16 and f32: the GroupNorm of a
    UNet call at 1024^2 (C = 192 in 32 groups of 6 channels, which straddle
    every 8-channel vector) and every attention and GroupNorm call of a
    MoVQ decode and encode at 1024^2 (one head of 512 over 128^2 = 16384
    tokens, held against the plain version over query chunks); each bf16
    attention on `wgmma-d512`."""
    from chiaswarm_tpu_torch.models import configs as cfgs

    _phase3(k3_calls(cfgs.K3UNetConfig(), cfgs.MoVQConfig(), 1024).values(), gen,
            "Kandinsky 3")


def cascade_checks(gen) -> None:
    """Phase 3 at Stable Cascade's shapes, in bf16 and f32: every attention
    call of a stage C call (2 CFG rows, 24^2 = 576 queries over 576 + 85
    keys, 32 heads of 64) and of a stage B call (one row, 32^2 and 16^2
    tokens over themselves and 4 pooled-text tokens, 20 heads of 64) at
    1024^2; each bf16 call on `wgmma-d64`."""
    from chiaswarm_tpu_torch.models import configs as cfgs

    _phase3(cascade_calls(cfgs.CASCADE_STAGE_C, cfgs.CASCADE_STAGE_B, 1024).values(), gen,
            "Stable Cascade")


def _phase3(parts, gen, what: str) -> None:
    attention, norms = Counter(), {}
    for part in parts:
        attention.update(part["flash_attention"])
        norms.update(dict.fromkeys(part["group_norm"]))
    for q_shape, k_shape, _ in attention:
        for dtype in (torch.bfloat16, torch.float32):
            row = attention_case(q_shape, k_shape, dtype, gen, timed=False)
            log(f"[check] flash_attention q{q_shape} kv{k_shape} {row['dtype']} route "
                f"{row['route']} ({what}): max_abs_err {row['max_abs_err']:.3g}"
                + (f", RMS err {row['rms_err']:.3g}" if "rms_err" in row else "")
                + f" (bound {row['bound']})")
            torch.cuda.empty_cache()
    for x_shape, _, silu, eps in norms:
        for dtype in (torch.bfloat16, torch.float32):
            row = gn_case(x_shape, dtype, silu, gen, timed=False, eps=eps)
            log(f"[check] group_norm x{x_shape} {row['dtype']} silu={silu} eps {eps:g} "
                f"({what}): max_abs_err {row['max_abs_err']:.3g} (bound {row['bound']})"
                + (f", on chip: {row['on_chip']}" if "on_chip" in row else ""))
    torch.cuda.empty_cache()


def _save_config(model_dir: Path, folder: str, payload: dict) -> None:
    (model_dir / folder).mkdir(parents=True, exist_ok=True)
    (model_dir / folder / "config.json").write_text(json.dumps(payload))


def write_kandinsky3(pipe, model_dir: Path, dtype=None) -> int:
    """A Kandinsky 3 bundle in the published diffusers layout, one
    safetensors file a folder (in `dtype`, the pipeline's unset): unet/,
    movq/ and the T5 text_encoder/, with the config.json fields the loader
    reads. -> bytes written."""
    u, m, t = pipe.unet_cfg, pipe.movq_cfg, pipe.t5_cfg
    nbytes = _save(pipe.unet, model_dir / "unet" / "diffusion_pytorch_model.safetensors", dtype)
    _save_config(model_dir, "unet", {"_class_name": "Kandinsky3UNet",
                                     "attention_head_dim": u.attention_head_dim,
                                     "groups": u.groups,
                                     "block_out_channels": list(u.block_out_channels),
                                     "layers_per_block": u.layers_per_block})
    nbytes += _save(pipe.movq, model_dir / "movq" / "diffusion_pytorch_model.safetensors", dtype)
    _save_config(model_dir, "movq", {"block_out_channels": list(m.block_out_channels),
                                     "layers_per_block": m.layers_per_block,
                                     "latent_channels": m.latent_channels,
                                     "vq_embed_dim": m.vq_embed_dim,
                                     "norm_num_groups": m.norm_num_groups, "norm_type": "spatial"})
    nbytes += _save(pipe.text_encoder, model_dir / "text_encoder" / "model.safetensors", dtype)
    _save_config(model_dir, "text_encoder", {
        "vocab_size": t.vocab_size, "d_model": t.d_model, "d_kv": t.d_kv,
        "num_heads": t.num_heads, "d_ff": t.d_ff, "num_layers": t.num_layers,
        "relative_attention_num_buckets": t.relative_attention_num_buckets,
        "relative_attention_max_distance": t.relative_attention_max_distance,
        "layer_norm_epsilon": t.layer_norm_epsilon, "feed_forward_proj": "gated-gelu"})
    return nbytes


def write_cascade(pipe, model_dir: Path, dtype=None) -> int:
    """A Stable Cascade prior or decoder repo in the published diffusers
    layout (in `dtype`, the pipeline's unset): prior/ or decoder/ with the
    config.json fields shapes cannot say, the CLIP-bigG text_encoder/ and
    a decoder's vqgan/. -> bytes written."""
    u, c = pipe.unet_cfg, pipe.clip_cfg
    stage = pipe.stage
    nbytes = _save(pipe.unet, model_dir / stage / "diffusion_pytorch_model.safetensors", dtype)
    _save_config(model_dir, stage, {
        "_class_name": "StableCascadeUNet", "patch_size": u.patch_size,
        "num_attention_heads": list(u.num_attention_heads), "clip_seq": u.clip_seq,
        "self_attn": u.self_attn, "timestep_conditioning_type": list(u.timestep_conditioning_type),
        "switch_level": None if u.switch_level is None else list(u.switch_level),
        "block_out_channels": list(u.block_out_channels)})
    nbytes += _save(pipe.text_encoder, model_dir / "text_encoder" / "model.safetensors", dtype)
    _save_config(model_dir, "text_encoder", {
        "vocab_size": c.vocab_size, "hidden_size": c.hidden_size,
        "num_hidden_layers": c.num_layers, "num_attention_heads": c.num_heads,
        "max_position_embeddings": c.max_positions, "hidden_act": c.hidden_act,
        "projection_dim": c.projection_dim})
    if pipe.vqgan is not None:
        v = pipe.vq_cfg
        nbytes += _save(pipe.vqgan, model_dir / "vqgan" / "diffusion_pytorch_model.safetensors",
                        dtype)
        _save_config(model_dir, "vqgan", {
            "_class_name": "PaellaVQModel", "levels": v.levels, "embed_dim": v.embed_dim,
            "bottleneck_blocks": v.bottleneck_blocks, "latent_channels": v.latent_channels,
            "scale_factor": v.scale_factor, "up_down_scale_factor": v.up_down_scale_factor})
    return nbytes


def _param_counts(modules: dict) -> dict:
    return {k: sum(p.numel() for p in m.parameters()) for k, m in modules.items()}


def _param_gib(modules) -> float:
    return sum(p.numel() * p.element_size() for m in modules for p in m.parameters()) / 2**30


def cli_check(root: Path, names: list, expect_ok: bool = True) -> tuple[int, str]:
    """`python3 -m chiaswarm_tpu_torch.initialize --silent --check --models
    ...` against `root`, in a settings root of its own -> (exit code,
    stdout)."""
    import os
    import tempfile

    with tempfile.TemporaryDirectory() as settings_root:
        env = dict(os.environ, SDAAS_ROOT=settings_root, CHIASWARM_MODEL_ROOT_DIR=str(root))
        proc = subprocess.run([sys.executable, "-m", "chiaswarm_tpu_torch.initialize",
                               "--silent", "--check", "--models", *names], cwd=str(ROOT),
                              env=env, capture_output=True, text=True, timeout=300)
    for line in proc.stdout.splitlines():
        log(f"[cli] {line}")
    if expect_ok and proc.returncode:
        log(proc.stderr[-3000:])
    return proc.returncode, proc.stdout


def check_cli_counts(stdout: str, expected: dict) -> None:
    """Every name of `expected` {name: {component: parameters}} printed "ok"
    with exactly those counts."""
    for name, counts in expected.items():
        line = next((ln for ln in stdout.splitlines() if ln.startswith(f"check {name}: ")), "")
        check(": ok (" in line, f"--check {name}: {line or 'no verdict'}")
        got = json.loads(line[line.index("{"):line.rindex("}") + 1])
        check(got == counts, f"--check {name}: counts {got} != the served modules' {counts}")


def k3_job(job_id: str, model: str, size: int, seed: int, workflow: str = "txt2img",
           steps: int = K3_STEPS, **extra) -> dict:
    params = {"pipeline_type": ("Kandinsky3Img2ImgPipeline" if workflow == "img2img"
                                else "Kandinsky3Pipeline"), "scheduler_type": "DDPMScheduler"}
    return {"id": job_id, "workflow": workflow, "model_name": model,
            "prompt": f"{K_PROMPT}, study {seed}", "negative_prompt": "blurry",
            "height": size, "width": size, "num_inference_steps": steps,
            "guidance_scale": K3_GUIDANCE, "seed": seed, "content_type": "image/png",
            "parameters": params, **extra}


def _hold_path(name: str, job: dict, cfg: dict, image, launches: dict, shapes: dict,
               hold: bool) -> dict:
    """Check one served envelope and hold its launches to `shapes` {kernel:
    Counter of counter keys}, in total and shape by shape -> the counted
    totals."""
    check(image.max() != image.min(), f"{job['id']}: constant image")
    check(cfg["latents"]["finite"], f"{job['id']}: non-finite latents")
    predicted = {k: sum(v.values()) for k, v in shapes.items()}
    counted = {k: v[0] for k, v in launches.items()}
    if hold:
        check(counted == predicted, f"{job['id']}: launches {counted} != {predicted}")
        for k, want in shapes.items():
            got = Counter({(tuple(key[0]), tuple(key[1]), *key[2:]) if k == "flash_attention"
                           else (tuple(key[0]), *key[1:]): n
                           for key, n in launches[k][1].items()})
            check(got == want, f"{job['id']}: {k} launches by shape differ from the configs' "
                  f"(counted less predicted {dict(got - want)}, predicted less counted "
                  f"{dict(want - got)})")
        for kernel, count in counted.items():
            check(count > 0 or not predicted[kernel],
                  f"{kernel} was never launched on the {name} path")
    return {"counted": counted, "predicted": predicted}


def _serve_jobs(registry, jobs, device, files=None):
    results, launches, wall = serve_group(registry, jobs, device, max_coalesce=1, files=files)
    out = []
    for job in jobs:
        r = results[job["id"]]
        cfg = r["pipeline_config"]
        check(not r.get("fatal_error") and "error" not in cfg, f"{job['id']}: {cfg}")
        image = decode_artifact(r["artifacts"]["primary"])
        check(image.shape == (job["height"], job["width"], 3),
              f"{job['id']}: image {image.shape}")
        out.append((job, cfg, image))
    return out, launches, wall


def _bf16_vs_f32(label: str, module, call, call_f32, around=None) -> dict:
    """One call of `module` in bf16 through the kernels against the same
    weights in f32 on the plain path; the plain path in bf16 gives the
    error bf16 itself makes (bound E2E_RATIO x that). `around(module)` is
    a context each of the three calls runs in (a LoRA delta's hooks)."""
    import copy

    around = around or (lambda m: nullcontext())
    with torch.inference_mode():
        with around(module):
            kernels = call(module).float()
        with plain_path():
            with around(module):
                plain = call(module).float()
            wide = copy.deepcopy(module).float()
            with around(wide):
                exact = call_f32(wide).float()
            del wide
        torch.cuda.synchronize()
    scale = rms(exact)
    row = {"rel_rms_err": rms(kernels - exact) / scale,
           "plain_bf16_rel_rms_err": rms(plain - exact) / scale,
           "finite": bool(torch.isfinite(kernels).all())}
    del kernels, plain, exact
    torch.cuda.empty_cache()
    log(f"[e2e] {label}, bf16 through the kernels vs f32 plain path: relative RMS err "
        f"{row['rel_rms_err']:.4g}; plain path in bf16: {row['plain_bf16_rel_rms_err']:.4g} "
        f"(bound {E2E_RATIO}x that)")
    check(row["finite"], f"{label}: non-finite output through the kernels")
    check(row["rel_rms_err"] <= E2E_RATIO * row["plain_bf16_rel_rms_err"],
          f"{label}: bf16 kernel path error {row['rel_rms_err']} > {E2E_RATIO} x the plain "
          f"bf16 path's {row['plain_bf16_rel_rms_err']}")
    return row


def _randn(shape, device, seed: int, dtype=torch.bfloat16):
    return torch.randn(shape, device=device,
                       generator=torch.Generator(device=device).manual_seed(seed)).to(dtype)


def _peak_above(device: str, fn):
    """fn() -> (its result, the most device memory it held above what was
    allocated before it, GiB; 0 off the card): a job's or a stage's
    activations, which capacity.py's per-image rows reckon."""
    if device != "cuda":
        return fn(), 0.0
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, (torch.cuda.max_memory_allocated() - base) / 2**30


def _check_reckoned(label: str, allocated_gib: float, peak_gib: float, reckoned_gib: float):
    """The bundle's device memory and its job's peak above it within what
    capacity.resident_bytes reckons for the model, on the card."""
    check(allocated_gib + peak_gib <= reckoned_gib,
          f"{label}: {allocated_gib:.3f} GiB resident + {peak_gib:.3f} GiB at its peak > "
          f"the {reckoned_gib:.3f} GiB capacity.resident_bytes reckons")


def _timings_line(t: dict) -> str:
    keys = ("job_s", "prior_s", "text_encode_s", "encode_s", "denoise_s", "unet_step_ms",
            "decode_s")
    return ", ".join(f"{k} {t[k]:.4g}" for k in keys if k in t)


def serve_kandinsky3_path(smi: str, device: str = "cuda", dtype=None, size: int = SIZE,
                          steps: int = K3_STEPS, hold: bool = True,
                          tiny: bool = False) -> tuple[dict, dict]:
    """Phase 5, the Kandinsky 3 path, in a registry of its own: the
    published bundle (FLAN-UL2's T5 encoder, the UNet, the 2.2 MoVQ) on
    seeded weights written as bf16 diffusers safetensors under a temporary
    root; the setup CLI's `--check` on it (every component "ok" with the
    served modules' parameter counts) and on a copy with one MoVQ tensor
    removed (FAILED, exit 1, the tensor named); the bundle built from the
    files by the registry and its folder removed; txt2img at 1024^2 (25
    DDPM steps, guidance 3.0) and img2img at strength 0.75 through the
    worker and the fake hive, each envelope checked and its launches held
    to `k3_calls` (UNet calls x a call's launches, a decode, an encode for
    img2img); the bundle's bf16 parameter bytes, each job's peak device
    memory above the bundle (held, with the bundle's, within
    capacity.resident_bytes), the job, stage and UNet step times printed;
    a bf16 UNet call against f32 on the plain path and
    profiles of a UNet call and a MoVQ decode. -> ({job kind: (1,
    launches)}, served). `tiny` rehearses the path on the CPU."""
    import gc
    import shutil
    import tempfile

    from safetensors.torch import load_file, save_file

    from chiaswarm_tpu_torch.capacity import resident_bytes
    from chiaswarm_tpu_torch.pipelines.kandinsky3 import Kandinsky3Pipeline, k3_checkpoint
    from chiaswarm_tpu_torch.registry import Registry

    dtype = dtype or (torch.bfloat16 if device == "cuda" else torch.float32)
    name = "test/tiny-kandinsky3" if tiny else K3
    size = 64 if tiny else size
    root = Path(tempfile.mkdtemp(prefix="kandinsky3-models-"))
    served, paths = {"jobs": {}, "allocated_gib_before": _allocated_gib(device)}, {}
    try:
        t0 = time.perf_counter()
        seeded = Kandinsky3Pipeline(name, device=device, dtype=dtype, allow_random_init=True)
        counts = _param_counts({"unet": seeded.unet, "movq": seeded.movq,
                                "text_encoder": seeded.text_encoder})
        nbytes = write_kandinsky3(seeded, root / name, dtype)
        del seeded
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        served["written"] = {"bytes": nbytes, "s": time.perf_counter() - t0}
        log(f"[kandinsky3] {name} seeded and written: {nbytes / 2**30:.2f} GiB in "
            f"{served['written']['s']:.1f}s")
        # the setup CLI on the tree, then on a copy with one MoVQ tensor removed
        t0 = time.perf_counter()
        rc, out = cli_check(root, [name])
        check(rc == 0, f"--check exit {rc}")
        check_cli_counts(out, {name: counts})
        broken = root / "broken" / name
        broken.mkdir(parents=True)
        for folder in ("unet", "text_encoder"):
            (broken / folder).symlink_to(root / name / folder)
        movq_file = k3_checkpoint(root / name)["files"]["movq"][0]
        state = load_file(str(movq_file))
        dropped = "decoder.conv_out.weight"
        del state[dropped]
        (broken / "movq").mkdir()
        shutil.copy(root / name / "movq" / "config.json", broken / "movq" / "config.json")
        save_file(state, str(broken / "movq" / movq_file.name))
        del state
        rc, out = cli_check(root / "broken", [name], expect_ok=False)
        check(rc == 1 and f"check {name}: FAILED" in out and dropped in out,
              f"--check of the copy without {dropped}: exit {rc}, {out!r}")
        shutil.rmtree(root / "broken")
        served["cli"] = {"s": time.perf_counter() - t0, "counts": counts}
        log(f"[kandinsky3] setup CLI --check: ok with the served modules' counts "
            f"{json.dumps(counts)}; the copy without {dropped}: FAILED, exit 1 "
            f"({served['cli']['s']:.1f}s for both)")

        registry = Registry(torch.device(device), str(root), safety_checker_model="")
        before = _allocated_gib(device)
        t0 = time.perf_counter()
        pipe = registry.get_pipeline(name, pipeline_type="Kandinsky3Pipeline")
        check(pipe.weights_source == "checkpoint", f"{name}: {pipe.weights_source}")
        shutil.rmtree(root / name)  # resident now: its files are not read again
        params = {"unet": pipe.unet, "movq": pipe.movq, "text_encoder": pipe.text_encoder}
        served["bundle"] = {
            "load_s": time.perf_counter() - t0, "read_bytes": pipe.checkpoint["bytes"],
            "allocated_gib": _allocated_gib(device) - before,
            "params_gib": {k: _param_gib([m]) for k, m in params.items()},
            "params_gib_total": _param_gib(params.values()),
            "reckoned_gib": resident_bytes(device, name) / 2**30}
        log(f"[kandinsky3] {name} resident in {served['bundle']['load_s']:.1f}s from "
            f"{pipe.checkpoint['bytes'] / 2**30:.2f} GiB of safetensors: "
            f"{served['bundle']['allocated_gib']:.2f} GiB allocated, bf16 parameters "
            f"{json.dumps({k: round(v, 3) for k, v in served['bundle']['params_gib'].items()})}"
            f" = {served['bundle']['params_gib_total']:.3f} GiB; capacity.resident_bytes "
            f"reckons {served['bundle']['reckoned_gib']:.3f} GiB with one image")
        calls = k3_calls(pipe.unet_cfg, pipe.movq_cfg, size, dtype=dtype)
        jobs = {"k3_txt2img": k3_job("k3-txt2img", name, size, 6101, steps=steps),
                "k3_img2img": k3_job("k3-img2img", name, size, 6201, workflow="img2img",
                                     steps=steps, start_image_uri="start", strength=0.75)}
        for kind, job in jobs.items():
            img2img = kind == "k3_img2img"
            files = {"start": image_bytes(start_image(size), "JPEG")} if img2img else None
            (done, launches, wall), peak = _peak_above(
                device, lambda: _serve_jobs(registry, [job], device, files))
            job, cfg, image = done[0]
            unet_calls = cfg["steps"] - (int(cfg["steps"] * 0.25) if img2img else 0)
            shapes = {}
            for k, per_call in calls["unet"].items():
                shapes[k] = Counter({key: unet_calls * n for key, n in per_call.items()})
                shapes[k].update(calls["decode"][k])
                if img2img:
                    shapes[k].update(calls["encode"][k])
            held = _hold_path("Kandinsky 3", job, cfg, image, launches, shapes, hold)
            t = cfg["timings"]
            log(f"[kandinsky3] {job['id']} ({name}, {size}^2, mode {cfg['mode']}, "
                f"{cfg['steps']} steps on {cfg['scheduler']}, {unet_calls} UNet calls) on {smi}: "
                f"{_timings_line(t)}; launches counted {json.dumps(held['counted'])}, predicted "
                f"{json.dumps(held['predicted'])}; pixels {int(image.min())}..{int(image.max())}; "
                f"peak {peak:.3f} GiB above the resident "
                f"{served['bundle']['allocated_gib']:.3f} GiB (reckoned in all "
                f"{served['bundle']['reckoned_gib']:.3f} GiB)")
            served["jobs"][job["id"]] = {"timings": t, **held, "wall_s": wall,
                                         "latents": cfg["latents"], "peak_act_gib": peak}
            paths[kind] = (1, launches)
            if device == "cuda":
                _check_reckoned(f"{name} {kind}", served["bundle"]["allocated_gib"], peak,
                                served["bundle"]["reckoned_gib"])
        if device == "cuda":
            lat = size // pipe.latent_factor
            x = _randn((2, 4, lat, lat), device, 11).contiguous(
                memory_format=torch.channels_last)
            tt = torch.full((2,), 500.0, device=device)
            ctx = _randn((2, 128, pipe.unet_cfg.encoder_hid_dim), device, 12)
            mask = torch.ones((2, 128), device=device)
            mask[0, 24:] = 0.0
            served["e2e_unet"] = _bf16_vs_f32(
                f"{name} UNet at {size}^2 (2 CFG rows)", pipe.unet,
                lambda m: m(x, tt, ctx, mask), lambda m: m(x.float(), tt, ctx.float(), mask))
            z = _randn((1, 4, lat, lat), device, 13)
            served["profile"] = profile_fns(name, size, 2, {
                "unet": (lambda: pipe.unet(x, tt, ctx, mask), 2),
                "movq_decode": (lambda: pipe.movq.decode(z), 2)}, pipe.device)
            log_profile(served["profile"], smi)
            check_one_launch_per_call(served["profile"])
            del x, ctx, mask, z
        del pipe, params, registry
    finally:
        shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    served["allocated_gib_after"] = _allocated_gib(device)
    log(f"[kandinsky3] path done: {served['allocated_gib_after']:.2f} GiB allocated after "
        f"({served['allocated_gib_before']:.2f} before)")
    if device == "cuda":
        check(served["allocated_gib_after"] <= served["allocated_gib_before"] + 0.5,
              f"the Kandinsky 3 path left {served['allocated_gib_after']:.2f} GiB allocated")
    return paths, served


def cascade_job(job_id: str, model: str, size: int, seed: int, pipeline_type: str,
                steps: int, **extra) -> dict:
    return {"id": job_id, "workflow": "txt2img", "model_name": model,
            "prompt": f"{K_PROMPT}, study {seed}", "negative_prompt": "blurry",
            "height": size, "width": size, "num_inference_steps": steps,
            "guidance_scale": 4.0, "seed": seed, "content_type": "image/png",
            "parameters": {"pipeline_type": pipeline_type, **extra}}


def serve_cascade_path(smi: str, device: str = "cuda", dtype=None, size: int = SIZE,
                       prior_steps: int = CASCADE_PRIOR_STEPS, hold: bool = True,
                       tiny: bool = False) -> tuple[dict, dict]:
    """Phase 5, the Stable Cascade path, in a registry of its own: the
    published prior (stage C, 2048 wide, 32 heads; CLIP-bigG) and decoder
    (stage B at (320, 640, 1280, 1280) with (0, 0, 20, 20) heads; CLIP-bigG;
    the Paella VQ) on seeded weights written as bf16 diffusers safetensors;
    the setup CLI's `--check` on both (ok, the served modules' counts);
    both built from the files and their folders removed; a prior-as-main
    job at 1024^2 with a `decoder` dict and a StableCascadeCombinedPipeline
    job (the job's 20 steps and guidance steer the prior, the decoder keeps
    its 10) through the worker and the fake hive, each envelope checked and
    its launches held to `cascade_calls` (prior steps x a stage C call's
    launches + decoder steps x a stage B call's); each bundle's bf16
    parameter bytes and the stage times printed; on the card, each stage's
    peak device memory above the bundles (the prior's generate, then the
    decoder's run on its embeddings, 2 steps each: a step's peak repeats),
    held with its bundle within capacity.resident_bytes; a bf16 stage C
    call and a stage B call against f32 on the plain path, and their
    profiles. -> ({job kind: (1, launches)}, served)."""
    import gc
    import shutil
    import tempfile

    from chiaswarm_tpu_torch.capacity import resident_bytes
    from chiaswarm_tpu_torch.pipelines.cascade import CascadePipeline, CascadePriorPipeline
    from chiaswarm_tpu_torch.registry import Registry

    decoder_steps = CASCADE_DECODER_STEPS
    dtype = dtype or (torch.bfloat16 if device == "cuda" else torch.float32)
    prior_name, decoder_name = (("test/tiny-cascade-prior", "test/tiny-cascade") if tiny
                                else (CASCADE_PRIOR, CASCADE))
    size = 64 if tiny else size
    root = Path(tempfile.mkdtemp(prefix="cascade-models-"))
    served, paths = {"jobs": {}, "allocated_gib_before": _allocated_gib(device)}, {}
    try:
        counts = {}
        for name, cls in ((prior_name, CascadePriorPipeline), (decoder_name, CascadePipeline)):
            t0 = time.perf_counter()
            seeded = cls(name, device=device, dtype=dtype, allow_random_init=True)
            counts[name] = _param_counts({"unet": seeded.unet, "text": seeded.text_encoder,
                                          **({"vqgan": seeded.vqgan} if seeded.vqgan else {})})
            nbytes = write_cascade(seeded, root / name, dtype)
            del seeded
            gc.collect()
            if device == "cuda":
                torch.cuda.empty_cache()
            served.setdefault("written", {})[name] = {"bytes": nbytes,
                                                      "s": time.perf_counter() - t0}
            log(f"[cascade] {name} seeded and written: {nbytes / 2**30:.2f} GiB in "
                f"{time.perf_counter() - t0:.1f}s")
        t0 = time.perf_counter()
        rc, out = cli_check(root, [prior_name, decoder_name])
        check(rc == 0, f"--check exit {rc}")
        check_cli_counts(out, counts)
        served["cli"] = {"s": time.perf_counter() - t0, "counts": counts}
        log(f"[cascade] setup CLI --check: ok with the served modules' counts "
            f"{json.dumps(counts)} ({served['cli']['s']:.1f}s)")

        registry = Registry(torch.device(device), str(root), safety_checker_model="")
        pipes = {}
        for name, kind in ((prior_name, "StableCascadePriorPipeline"),
                           (decoder_name, "StableCascadeDecoderPipeline")):
            before, t0 = _allocated_gib(device), time.perf_counter()
            pipe = pipes[name] = registry.get_pipeline(name, pipeline_type=kind)
            check(pipe.weights_source == "checkpoint", f"{name}: {pipe.weights_source}")
            shutil.rmtree(root / name)
            modules = [pipe.unet, pipe.text_encoder] + ([pipe.vqgan] if pipe.vqgan else [])
            served.setdefault("bundle", {})[name] = {
                "load_s": time.perf_counter() - t0, "read_bytes": pipe.checkpoint["bytes"],
                "allocated_gib": _allocated_gib(device) - before,
                "params_gib": _param_gib(modules),
                "reckoned_gib": resident_bytes(device, name) / 2**30}
            b = served["bundle"][name]
            log(f"[cascade] {name} resident in {b['load_s']:.1f}s: {b['allocated_gib']:.2f} GiB "
                f"allocated, bf16 parameters {b['params_gib']:.3f} GiB; "
                f"capacity.resident_bytes reckons {b['reckoned_gib']:.3f} GiB with one image")
        del pipe, modules  # the registry's and `pipes`' references are the ones released below
        prior, decoder = pipes[prior_name], pipes[decoder_name]
        calls = cascade_calls(prior.unet_cfg, decoder.unet_cfg, size, dtype, tiny=tiny)
        jobs = {"cascade_prior_main": cascade_job(
                    "cascade-prior", prior_name, size, 7101, "StableCascadePriorPipeline",
                    prior_steps, decoder={"model_name": decoder_name,
                                          "pipeline_type": "StableCascadeDecoderPipeline",
                                          "num_inference_steps": decoder_steps}),
                "cascade_combined": cascade_job(
                    "cascade-combined", decoder_name, size, 7201,
                    "StableCascadeCombinedPipeline", prior_steps)}
        for kind, job in jobs.items():
            done, launches, wall = _serve_jobs(registry, [job], device)
            job, cfg, image = done[0]
            check(cfg["steps"] == decoder_steps, f"{job['id']}: decoder steps {cfg['steps']}")
            shapes = {}
            for k in ("flash_attention", "group_norm"):
                shapes[k] = Counter({key: prior_steps * n
                                     for key, n in calls["prior"][k].items()})
                shapes[k].update({key: decoder_steps * n
                                  for key, n in calls["decoder"][k].items()})
            held = _hold_path("Stable Cascade", job, cfg, image, launches, shapes, hold)
            t = cfg["timings"]
            log(f"[cascade] {job['id']} ({cfg['pipeline']}, {size}^2, prior {prior_steps} steps "
                f"guided, decoder {cfg['steps']} unguided) on {smi}: {_timings_line(t)}; "
                f"launches counted {json.dumps(held['counted'])}, predicted "
                f"{json.dumps(held['predicted'])}; pixels {int(image.min())}..{int(image.max())}")
            served["jobs"][job["id"]] = {"timings": t, **held, "wall_s": wall,
                                         "latents": cfg["latents"]}
            paths[kind] = (1, launches)
        if device == "cuda":
            embeds, peak_c = _peak_above(device, lambda: prior.generate(
                K_PROMPT, "blurry", 1, 2, 4.0, size, size))
            _, peak_b = _peak_above(device, lambda: decoder.run(
                K_PROMPT, image_embeddings=embeds, num_inference_steps=2, height=size,
                width=size))
            del embeds
            for name, peak in ((prior_name, peak_c), (decoder_name, peak_b)):
                b = served["bundle"][name]
                b["peak_act_gib"] = peak
                log(f"[cascade] {name}'s stage at {size}^2 on {smi}: peak {peak:.3f} GiB above "
                    f"the resident bundles ({b['allocated_gib']:.3f} GiB its own; reckoned in "
                    f"all {b['reckoned_gib']:.3f} GiB)")
                _check_reckoned(f"{name}'s stage", b["allocated_gib"], peak, b["reckoned_gib"])
            grid = prior.grid(size, size)
            c, b = prior.unet_cfg, decoder.unet_cfg
            xc = _randn((2, c.in_channels, *grid), device, 21).contiguous(
                memory_format=torch.channels_last)
            rc_ = torch.full((2,), 0.5, device=device)
            pooled = _randn((2, 1, c.clip_text_pooled_in_channels), device, 22)
            text = _randn((2, CASCADE_TEXT_TOKENS, c.clip_text_in_channels), device, 23)
            img = torch.zeros((2, 1, c.clip_image_in_channels), device=device, dtype=dtype)
            lat = decoder.latent_grid(*grid)
            xb = _randn((1, b.in_channels, *lat), device, 24).contiguous(
                memory_format=torch.channels_last)
            rb = torch.full((1,), 0.5, device=device)
            effnet = _randn((1, b.effnet_in_channels, *grid), device, 25)
            served["e2e_stage_c"] = _bf16_vs_f32(
                f"{prior_name} stage C at {size}^2 (2 CFG rows)", prior.unet,
                lambda m: m(xc, rc_, pooled, clip_text=text, clip_img=img),
                lambda m: m(xc.float(), rc_, pooled.float(), clip_text=text.float(),
                            clip_img=img.float()))
            served["e2e_stage_b"] = _bf16_vs_f32(
                f"{decoder_name} stage B at {size}^2 (1 row)", decoder.unet,
                lambda m: m(xb, rb, pooled[:1], effnet=effnet),
                lambda m: m(xb.float(), rb, pooled[:1].float(), effnet=effnet.float()))
            served["profile"] = profile_fns(decoder_name, size, 1, {
                "stage_c": (lambda: prior.unet(xc, rc_, pooled, clip_text=text, clip_img=img), 2),
                "stage_b": (lambda: decoder.unet(xb, rb, pooled[:1], effnet=effnet), 2),
                "paella_decode": (lambda: decoder.vqgan(xb), 2)}, decoder.device)
            log_profile(served["profile"], smi)
            del xc, pooled, text, img, xb, effnet
        del prior, decoder, pipes, registry
    finally:
        shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    served["allocated_gib_after"] = _allocated_gib(device)
    log(f"[cascade] path done: {served['allocated_gib_after']:.2f} GiB allocated after "
        f"({served['allocated_gib_before']:.2f} before)")
    if device == "cuda":
        check(served["allocated_gib_after"] <= served["allocated_gib_before"] + 0.5,
              f"the Stable Cascade path left {served['allocated_gib_after']:.2f} GiB allocated")
    return paths, served


def measure(paths: dict, main: str = "txt2img") -> tuple[list[dict], dict]:
    """Phase 6 for {job kind: (jobs, {kernel: (launches, {shape key:
    launches})})} counted over `jobs` jobs of each kind: every shape that
    any kind launched is checked and timed once; each kernel's times and
    bound per job are summed over its shapes for each kind. The summary
    reports the `main` kind's job at the top level, as before, and every
    kind under `by_job`; `launches` counts every served job."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    detail, summary = {}, []
    names = list(next(iter(paths.values()))[1])
    for name in names:
        shapes = Counter()
        for _, launches in paths.values():
            shapes.update(launches[name][1])
        rows, routes = [], Counter()
        for key, count in sorted(shapes.items(), key=lambda kv: -kv[1]):
            if name == "flash_attention":
                q_shape, k_shape, dtype = key
                row = attention_case(tuple(q_shape), tuple(k_shape), dtype, gen, timed=True)
            else:
                x_shape, dtype, silu, eps = key
                row = gn_case(x_shape, getattr(torch, dtype), silu, gen, timed=True, eps=eps)
            row["launches_per_job"] = {kind: launches[name][1].get(key, 0) / jobs
                                       for kind, (jobs, launches) in paths.items()}
            if row.get("route"):
                routes[f"{row['route']} {row['dtype']}"] += count
            rows.append(row)
            row["tflops"] = row["flops"] / row["ms"] / 1e9
            row["share_of_bound"] = row["bound_ms"] / row["ms"]
            per_kind = ", ".join(f"{kind} {n:g}" for kind, n in row["launches_per_job"].items()
                                 if n)
            log(f"[measure] {name} {row.get('q', row.get('x'))}"
                f"{' kv' + str(row['kv']) if 'kv' in row else ''} {row['dtype']}"
                f"{' eps %g' % row['eps'] if 'eps' in row else ''}"
                f"{' on chip: %s' % row['on_chip'] if 'on_chip' in row else ''}"
                f"{' route ' + row['route'] if row.get('route') else ''}: "
                f"per job {per_kind}; kernel {row['ms']:.4f} ms"
                + f" (device {row['device_ms']:.4f}, host {row['host_ms']:.4f})"
                + f", plain {row['plain_ms']:.4f} ms, library {row['library_ms']:.4f} ms"
                + (f" (device {row['library_device_ms']:.4f})" if "library_device_ms" in row
                   else "")
                + f", bound {row['bound_ms']:.4f} ms "
                f"({row['bound_by']}), {row['tflops']:.1f} TFLOP/s, "
                f"{100 * row['share_of_bound']:.1f}% of bound, err {row['max_abs_err']:.3g}")

        def per_job(field, kind, which=None):
            return sum(r[field] * r["launches_per_job"][kind] for r in rows
                       if which is None or r["bound_by"] == which)

        # each shape's own bound (the larger of its two), summed over the
        # shapes; bound_by names the kind that makes up most of the sum
        by_job = {}
        for kind, (jobs, launches) in paths.items():
            by_ops = per_job("bound_ms", kind, "operations")
            by_bytes = per_job("bound_ms", kind, "bytes")
            by_job[kind] = {
                "launches": launches[name][0] / jobs, "ms": per_job("ms", kind),
                "device_ms": per_job("device_ms", kind), "host_ms": per_job("host_ms", kind),
                "plain_ms": per_job("plain_ms", kind), "bound_ms": by_ops + by_bytes,
                "bound_by": "operations" if by_ops >= by_bytes else "bytes",
                "library_ms": per_job("library_ms", kind),
                "library_device_ms": per_job("library_device_ms", kind)}
            j = by_job[kind]
            log(f"[measure] {name} per {kind} job: kernel {j['ms']:.1f} ms (device "
                f"{j['device_ms']:.1f}, host {j['host_ms']:.1f}), plain {j['plain_ms']:.1f} ms, "
                f"library {j['library_ms']:.1f} ms (device {j['library_device_ms']:.1f}), bound "
                f"{j['bound_ms']:.1f} ms ({j['bound_by']}), {j['launches']:g} launches")
        top = {k: v for k, v in by_job[main].items() if k not in ("launches", "library_device_ms")}
        summary.append({
            "name": name, "route": "cuda", **KERNELS[name],
            "launches": sum(launches[name][0] for _, launches in paths.values()),
            "max_abs_err": max(r["max_abs_err"] for r in rows), **top, "by_job": by_job,
            # every route the served paths launched, by its launches
            **({"routes": dict(routes)} if routes else {}),
        })
        detail[name] = rows
    return summary, detail


# --- phases 7 and 8 ---

# kernel-name marks of each category; the GroupNorm names of the
# three-launch kernel (stats, finalize, apply) stay so that
# `--group-norm-only` can profile such a tree beside the one-launch kernel
_GN_MARKS = ("gn_fused", "gn_stats", "gn_finalize", "gn_apply")
LORA_CATEGORY = "lora delta (x·Aᵀ, then addmm into y)"
_CATEGORIES = (
    ("flash_attention kernel", ("flash_fwd",)),
    ("group_norm kernel", _GN_MARKS),
    ("convolution (cuDNN)", ("fprop", "conv", "dgrad", "implicit", "winograd")),
    ("matmul (cuBLAS)", ("gemm", "nvjet", "cutlass", "xmma", "cublas")),
)


def unet_inputs(pipe, size: int = SIZE, dtype=None, seed: int = 2, rows: int = 2):
    """(x, t, context, added_cond) for one UNet call at the main path's
    shapes: `rows` CFG rows (pix2pix 3), size/8 latents of the UNet's input
    channels, 77 context tokens, the pipeline's own time ids."""
    dev, cfg = pipe.device, pipe.unet.config
    dtype = dtype or pipe.dtype
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    lat = size // pipe.latent_factor
    x = randn(rows, cfg.in_channels, lat, lat).contiguous(memory_format=torch.channels_last)
    t = torch.full((rows,), 500.0, device=dev)
    ctx = randn(rows, 77, cfg.cross_attention_dim)
    if not cfg.addition_embed_dim:
        return x, t, ctx, None
    pooled = cfg.addition_embed_dim - pipe.n_time_ids * cfg.addition_time_embed_dim
    added = {"text_embeds": randn(rows, pooled),
             "time_ids": torch.tensor([pipe._xl_time_ids(size, size)] * rows, device=dev,
                                      dtype=torch.float32)}
    return x, t, ctx, added


@contextmanager
def plain_path():
    """Route the attention of the UNet, the VAE, the K-UNet, the safety
    checker, DPT, the Flux transformer and the Stable Cascade UNet, and the
    GroupNorm of the UNet and the VAE (and of every FusedGroupNorm, the
    Kandinsky 3 UNet's output norm among them), to the plain PyTorch
    versions, on the card, for the duration."""
    from chiaswarm_tpu_torch.models import (
        cascade_unet,
        depth,
        flux,
        k_upscaler,
        layers,
        safety,
        vae,
    )
    from chiaswarm_tpu_torch.ops.flash_attention import reference_attention
    from chiaswarm_tpu_torch.ops.group_norm import reference_group_norm

    def plain_group_norm(x, scale, bias, *, groups=32, eps=1e-5, act=None):
        return reference_group_norm(x, scale, bias, groups, eps, act == "silu")

    attending = (layers, vae, k_upscaler, safety, depth, flux, cascade_unet)
    saved = [m.dot_product_attention for m in attending], layers.group_norm
    for module in attending:
        module.dot_product_attention = reference_attention
    layers.group_norm = plain_group_norm
    try:
        yield
    finally:
        for module, fn in zip(attending, saved[0]):
            module.dot_product_attention = fn
        layers.group_norm = saved[1]


def encode_input(pipe, size: int = SIZE):
    """The served start image as the VAE encoder's input: [1, 3, size,
    size] in [-1, 1], the pipeline's dtype, channels_last."""
    import numpy as np

    px = np.asarray(start_image(size), np.float32) / 127.5 - 1.0
    px = torch.from_numpy(px.transpose(2, 0, 1)[None].copy()).to(pipe.device, pipe.dtype)
    return px.contiguous(memory_format=torch.channels_last)


def adapter_context(adapter, rows: int):
    """-> delta(module): a context applying `adapter` (matched factors,
    gain) to that UNet, its stacks built in the module's own dtype; a
    context that does nothing when `adapter` is None."""
    from chiaswarm_tpu_torch.models.lora import linear_index
    from chiaswarm_tpu_torch.pipelines import lora_runtime

    def delta(module):
        if adapter is None:
            return nullcontext()
        matched, gain = adapter
        weight = next(module.parameters())
        stacks, _ = lora_runtime.build_stacks(matched, weight.dtype, weight.device)
        return lora_runtime.applied(linear_index(module), stacks, gain, rows)
    return delta


def control_input(pipe, size: int, rows: int, seed: int = 4):
    """A control image for one ControlNet call: [rows, 3, size, size] in
    [0, 1], the pipeline's dtype, channels_last."""
    gen = torch.Generator(device=pipe.device).manual_seed(seed)
    cond = torch.rand((rows, 3, size, size), generator=gen, device=pipe.device)
    return cond.to(pipe.dtype).contiguous(memory_format=torch.channels_last)


def _residuals(out) -> torch.Tensor:
    """A ControlNet call's (per-skip residuals, mid residual) as one flat
    f32 tensor."""
    down, mid = out
    return torch.cat([r.float().reshape(-1) for r in (*down, mid)])


def end_to_end_bf16_check(pipe, size: int = SIZE,
                          parts=("unet", "vae_decode", "vae_encode"), rows: int = 2,
                          adapter=None, branch=None) -> dict:
    """One UNet call (`rows` CFG rows), one VAE decode and one VAE encode
    (the named parts) at the shapes of `pipe`'s path at `size`, in bf16
    through the kernels, against the same weights in f32 on the plain path;
    the plain path in bf16 gives the error bf16 itself makes. `adapter`
    (matched factors, gain) applies its delta to the UNet call on all three
    paths, from stacks in each path's dtype. The part "controlnet" is one
    call of `branch` (a ControlNet of `pipe`'s UNet) at the UNet call's
    inputs and a control image, its residuals compared as one tensor."""
    check(pipe.dtype == torch.bfloat16, f"the main path runs {pipe.dtype}, not bf16")
    lat = size // pipe.latent_factor
    x, t, ctx, added = unet_inputs(pipe, size, rows=rows)
    z = torch.randn((1, pipe.latent_channels, lat, lat), device=pipe.device,
                    generator=torch.Generator(device=pipe.device).manual_seed(3))
    z = z.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    # the f32 reference sees the same bf16 input values, cast up
    up = added and {"text_embeds": added["text_embeds"].float(), "time_ids": added["time_ids"]}
    px = encode_input(pipe, size)
    cond = control_input(pipe, size, rows) if branch is not None else None
    delta = adapter_context(adapter, rows)
    calls = (
        ("unet", pipe.unet, lambda m: m(x, t, ctx, added),
         lambda m: m(x.float(), t, ctx.float(), up)),
        ("vae_decode", pipe.vae, lambda m: m.decode(z), lambda m: m.decode(z.float())),
        ("vae_encode", pipe.vae, lambda m: m.encode(px), lambda m: m.encode(px.float())),
        ("controlnet", branch, lambda m: _residuals(m(x, t, ctx, cond, 1.0, added)),
         lambda m: _residuals(m(x.float(), t, ctx.float(), cond.float(), 1.0, up))))
    result = {}
    for name, module, call, call_f32 in calls:
        if name not in parts:
            continue
        label = (f"{pipe.model_name} {name} at {size}^2"
                 + (f" ({rows} CFG rows)" if name in ("unet", "controlnet") else "")
                 + (", LoRA delta active" if adapter is not None and name == "unet" else ""))
        result[name] = _bf16_vs_f32(label, module, call, call_f32,
                                    delta if name == "unet" else None)
    return result


# idle host time on either side of the calls a profile counts
PROFILE_MARGIN_S = 0.05


def profiled(fn, calls: int, device) -> tuple[dict, float, float, int, dict]:
    """`calls` calls of fn after one warm-up call, timed by the host's clock
    and then again under torch.profiler: ({kernel name: (device ms per
    call, launches per call)}, wall ms per call unprofiled, the same under
    the profiler, GroupNorm wrapper calls per call, {kernel name: (device
    ms, launches) per call} of the kernels launched inside `lora_delta`
    ranges)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from chiaswarm_tpu_torch.device import synchronize
    from chiaswarm_tpu_torch.ops.group_norm import COUNTER as GN_COUNTER

    with torch.inference_mode():
        fn()
        synchronize(device)
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        synchronize(device)
        plain_wall_ms = 1e3 * (time.perf_counter() - t0) / calls
        # one call in the schedule's warm-up step, whose events are dropped:
        # the device's tracing is running before the counted calls start (a
        # profile that began with them once lost the first kernels of a
        # VAE decode). The profiler keeps only the kernels that its clock
        # places inside the active window, and the device's timestamps are
        # converted to the host's clock only approximately: an idle margin
        # on either side of the counted calls keeps their first and last
        # kernels inside it (without one, an SD UNet profile once counted
        # 60 GroupNorm launches of 61).
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1), acc_events=True) as prof:
            fn()
            synchronize(device)
            prof.step()
            time.sleep(PROFILE_MARGIN_S)
            GN_COUNTER.reset()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            synchronize(device)
            wall_ms = 1e3 * (time.perf_counter() - t0) / calls
            time.sleep(PROFILE_MARGIN_S)
            prof.step()
    kernels = {}
    for event in prof.key_averages():
        device_us = getattr(event, "self_device_time_total", None)
        if device_us is None:
            device_us = getattr(event, "self_cuda_time_total", 0)
        # a record_function range's own span on the device is no kernel,
        # nor is the schedule's step range
        if (device_us > 0 and event.key != "lora_delta"
                and not event.key.startswith("ProfilerStep")
                and getattr(event, "device_type", None) != torch.autograd.DeviceType.CPU):
            ms, n = kernels.get(event.key, (0.0, 0.0))
            kernels[event.key] = (ms + device_us / 1e3 / calls, n + event.count / calls)
    delta = {}

    def under(event):
        for kernel in getattr(event, "kernels", ()):
            ms, n = delta.get(kernel.name, (0.0, 0.0))
            delta[kernel.name] = (ms + kernel.duration / 1e3 / calls, n + 1 / calls)
        for child in event.cpu_children:
            under(child)

    for event in prof.events():
        if event.name == "lora_delta" and event.device_type == torch.autograd.DeviceType.CPU:
            under(event)
    return kernels, plain_wall_ms, wall_ms, GN_COUNTER.launches // calls, delta


def profile_main_path(pipe, size: int = SIZE, steps: int = 3,
                      parts=("unet", "vae_decode", "vae_encode"), rows: int = 2,
                      adapter=None, branch=None) -> dict:
    """Phase 8: torch.profiler over a few UNet calls (`rows` CFG rows,
    size/8 latents), one VAE decode and one VAE encode (the named parts) of
    `pipe` at `size`: device time and launches by kernel category, each
    GroupNorm kernel by name, GroupNorm wrapper calls, and the device's
    busy share of the wall time. With `adapter` (matched factors, gain) the
    UNet calls carry its delta, whose kernels form a category of their
    own. The part "controlnet" is a few calls of `branch` at the UNet
    call's inputs."""
    x, t, ctx, added = unet_inputs(pipe, size, rows=rows)
    cond = control_input(pipe, size, rows) if branch is not None else None
    delta = adapter_context(adapter, rows)
    lat = size // pipe.latent_factor
    z = torch.randn((1, pipe.latent_channels, lat, lat), device=pipe.device,
                    generator=torch.Generator(device=pipe.device).manual_seed(3))
    z = z.to(pipe.dtype).contiguous(memory_format=torch.channels_last)
    px = encode_input(pipe, size)
    fns = {name: fn_calls for name, fn_calls in (
        ("unet", (lambda: pipe.unet(x, t, ctx, added_cond=added), steps)),
        ("vae_decode", (lambda: pipe.vae.decode(z), 1)),
        ("vae_encode", (lambda: pipe.vae.encode(px), 1)),
        ("controlnet", (lambda: branch(x, t, ctx, cond, 1.0, added), steps))) if name in parts}
    return profile_fns(pipe.model_name, size, rows, fns, pipe.device,
                       lambda name: delta(pipe.unet) if name == "unet" else nullcontext(),
                       adapter is not None)


def profile_fns(model: str, size: int, rows: int, fns: dict, device, around=None,
                adapter: bool = False) -> dict:
    """torch.profiler over {part: (fn, calls)}: device time and launches by
    kernel category, each GroupNorm kernel by name, GroupNorm wrapper
    calls, and the device's busy share of the wall time, per call of each
    part; `around(part)` is a context each part's calls run in, and with
    `adapter` the "unet" part's delta kernels form a category of their
    own."""
    result = {}
    for name, (fn, calls) in fns.items():
        with around(name) if around else nullcontext():
            kernels, plain_wall_ms, wall_ms, gn_calls, delta_kernels = profiled(
                fn, calls, device)
        categories = {label: [0.0, 0.0] for label, _ in _CATEGORIES}
        categories["other (elementwise, norms, copies)"] = [0.0, 0.0]

        def category(kernel):
            low = kernel.lower()
            return next((label for label, marks in _CATEGORIES if any(m in low for m in marks)),
                        "other (elementwise, norms, copies)")

        for kernel, (ms, n) in kernels.items():
            categories[category(kernel)][0] += ms
            categories[category(kernel)][1] += n
        if adapter and name == "unet":
            # the delta's kernels leave the category their names put them in
            categories[LORA_CATEGORY] = [0.0, 0.0]
            for kernel, (ms, n) in delta_kernels.items():
                for label, sign in ((category(kernel), -1), (LORA_CATEGORY, 1)):
                    categories[label][0] += sign * ms
                    categories[label][1] += sign * n
        device_ms = sum(ms for ms, _ in kernels.values())
        result[name] = {
            "model": model, "size": size, "rows": rows,
            "calls": calls, "unprofiled_wall_ms_per_call": plain_wall_ms,
            "wall_ms_per_call": wall_ms, "device_ms_per_call": device_ms,
            "busy_share": device_ms / wall_ms if wall_ms else None,
            "categories_ms_launches": categories,
            "group_norm_kernels": {k: v for k, v in kernels.items()
                                   if any(m in k.lower() for m in _GN_MARKS)},
            "group_norm_calls": gn_calls,
            "top_kernels_ms": sorted(((k, ms) for k, (ms, _) in kernels.items()),
                                     key=lambda kv: -kv[1])[:8],
            "lora_delta_kernels": delta_kernels}
    return result


def log_profile(profile: dict, smi: str) -> None:
    for name, p in profile.items():
        if p["device_ms_per_call"] <= 0:
            log(f"[profile] {name}: the profiler saw no device kernels; device time not measured")
            continue
        attention_ms = p["categories_ms_launches"]["flash_attention kernel"][0]
        log(f"[profile] {p['model']} {name} ({p['size']}^2"
            f"{', CFG batch %d' % p.get('rows', 2) if name in ('unet', 'controlnet') else ''}) "
            f"on {smi}: "
            f"wall {p['wall_ms_per_call']:.2f} ms per call ({p['unprofiled_wall_ms_per_call']:.2f} "
            f"unprofiled), device busy {p['device_ms_per_call']:.2f} ms "
            f"({100 * p['busy_share']:.1f}% of the profiled wall); attention "
            f"{100 * attention_ms / p['device_ms_per_call']:.1f}% of the device time")
        for label, (ms, n) in p["categories_ms_launches"].items():
            log(f"[profile]   {label}: {ms:.3f} ms, {n:g} launches")
        log(f"[profile]   group_norm: {p['group_norm_calls']} wrapper calls per call")
        for kernel, (ms, n) in p["group_norm_kernels"].items():
            log(f"[profile]   group_norm kernel {ms:.3f} ms, {n:g} launches: {kernel[:90]}")
        for kernel, ms in p["top_kernels_ms"]:
            log(f"[profile]   top kernel {ms:.3f} ms: {kernel[:110]}")


def check_one_launch_per_call(profile: dict) -> None:
    """Every GroupNorm wrapper call is exactly one kernel launch."""
    for name, p in profile.items():
        launches = p["categories_ms_launches"]["group_norm kernel"][1]
        check(launches == p["group_norm_calls"],
              f"{p['model']} {name} at {p.get('rows', 2)} CFG rows: {launches:g} GroupNorm "
              f"kernel launches for {p['group_norm_calls']} calls")


def group_norm_only(smi: str, detail: str | None) -> None:
    """GroupNorm alone: phase 6 at the shapes of one UNet call and one VAE
    decode (per job: STEPS UNet calls and one decode), then phase 8."""
    from chiaswarm_tpu_torch.ops.group_norm import COUNTER as GN_COUNTER
    from chiaswarm_tpu_torch.pipelines.stable_diffusion import SDPipeline

    pipe = SDPipeline(SDXL, device="cuda", allow_random_init=True)
    x, t, ctx, added = unet_inputs(pipe)
    lat = SIZE // pipe.latent_factor
    z = torch.zeros((1, pipe.latent_channels, lat, lat), device="cuda", dtype=pipe.dtype)
    z = z.contiguous(memory_format=torch.channels_last)
    per_job = {}
    with torch.inference_mode():
        for fn, times in ((lambda: pipe.unet(x, t, ctx, added_cond=added), STEPS),
                          (lambda: pipe.vae.decode(z), 1)):
            GN_COUNTER.reset()
            fn()
            for key, n in GN_COUNTER.shapes.items():
                per_job[key] = per_job.get(key, 0) + n * times
    summary, shapes = measure({"txt2img": (1, {"group_norm": (sum(per_job.values()),
                                                              per_job)})})
    profile = profile_main_path(pipe)
    log_profile(profile, smi)
    if detail:
        path = Path(detail)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps({"card": smi, "kernels": summary, "shapes": shapes,
                                    "profile": profile}, indent=1))


def attention_only(smi: str, detail: str | None) -> None:
    """Attention alone: the checks of phase 3 (Flux's too), then phase 6 at
    the shapes of one UNet call and one VAE decode of each model in
    UNET_ATTENTION (per job: STEPS UNet calls and one decode) and of a
    FLUX.1-dev 1024^2 job (FLUX_DEV_STEPS transformer calls and one
    decode)."""
    attention_checks(torch.Generator(device="cuda").manual_seed(0))
    flux_checks(torch.Generator(device="cuda").manual_seed(5))
    paths = {}
    for model in UNET_ATTENTION:
        per_job = Counter({key: n * STEPS for key, n in attention_shapes(model).items()})
        per_job[vae_attention_shape(model)] += 1
        paths[f"{model} txt2img"] = (1, {"flash_attention": (sum(per_job.values()),
                                                             dict(per_job))})
    # a FLUX.1-dev 1024^2 job: 28 transformer calls and one decode
    per_job = Counter({flux_attention_shape(): FLUX_BLOCKS * FLUX_DEV_STEPS,
                       vae_attention_shape("sdxl"): 1})
    paths["flux txt2img"] = (1, {"flash_attention": (sum(per_job.values()), dict(per_job))})
    summary, shapes = measure(paths, main="sdxl txt2img")
    if detail:
        path = Path(detail)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps({"card": smi, "kernels": summary, "shapes": shapes},
                                   indent=1, default=str))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--detail", help="write every measurement to this JSON file")
    parser.add_argument("--group-norm-only", action="store_true",
                        help="phases 1, 2, 6 and 8 for GroupNorm alone (no result line)")
    parser.add_argument("--attention-only", action="store_true",
                        help="phases 1, 2, 3 and 6 for attention alone (no result line)")
    opts = parser.parse_args(argv)
    started = last = time.perf_counter()

    def mark(phase: str) -> None:
        nonlocal last
        now = time.perf_counter()
        log(f"[time] {phase}: {now - last:.1f}s (at {now - started:.1f}s)")
        last = now

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs the card",
              file=sys.stderr)
        return 1
    import os
    import shutil
    import tempfile

    # the workers' outboxes and profiles land in a root of the smoke's own
    sdaas_root = tempfile.mkdtemp(prefix="chip-smoke-root-")
    os.environ["SDAAS_ROOT"] = sdaas_root
    try:
        smi = device_probe()
        from chiaswarm_tpu_torch.device import set_precision
        from chiaswarm_tpu_torch.ops import _build
        from chiaswarm_tpu_torch.registry import Registry

        set_precision()
        t0 = time.perf_counter()
        paths = _build.build(("flash_attention",) if opts.attention_only else _build.SOURCES)
        log(f"[build] {len(paths)} kernel libraries in {time.perf_counter() - t0:.1f}s: "
            + ", ".join(p.name for p in paths.values()))
        for name in paths:
            regs = [ln.strip() for ln in _build.build_log(name).splitlines()
                    if "registers" in ln or "spill" in ln]
            log(f"[build] {name}: " + " | ".join(regs))
        if opts.group_norm_only:
            group_norm_only(smi, opts.detail)
            return 0
        if opts.attention_only:
            attention_only(smi, opts.detail)
            return 0
        mark("phases 1-2 build")
        kernel_checks()
        mark("phase 3 kernel checks")
        flux_checks(torch.Generator(device="cuda").manual_seed(5))
        mark("phase 3 flux checks")
        limits = batched_checks(torch.Generator(device="cuda").manual_seed(2))
        mark("phase 3 batched checks")
        upscale_checks(torch.Generator(device="cuda").manual_seed(3))
        mark("phase 3 upscale checks")
        preprocessor_checks(torch.Generator(device="cuda").manual_seed(4))
        mark("phase 3 preprocessor checks")
        kandinsky_checks(torch.Generator(device="cuda").manual_seed(6))
        mark("phase 3 Kandinsky checks")
        kandinsky3_checks(torch.Generator(device="cuda").manual_seed(7))
        cascade_checks(torch.Generator(device="cuda").manual_seed(8))
        mark("phase 3 Kandinsky 3 and Stable Cascade checks")
        tiny_reference_check()
        tiny_sd = tiny_sd_checks()
        tiny_image = tiny_image_checks()
        tiny_edit = tiny_edit_checks()
        tiny_adapters = tiny_adapter_checks()
        tiny_batched = tiny_batched_checks()
        tiny_flux = tiny_flux_checks()
        tiny_kandinsky = tiny_kandinsky_checks()
        mark("phase 4 tiny checks")
        launches, served, registry = serve_main_path(smi)
        unet_launches = {name: (count / N_JOBS - DECODE_LAUNCHES[name]) / STEPS
                         for name, (count, _) in launches.items()}
        mark("phase 5 main path")
        image_paths, image_served = serve_image_path(smi, registry, unet_launches)
        mark("phase 5 image path")
        # the SD models in a registry of their own: with the SDXL base, its
        # inpaint checkpoint, the refiner and the SDXL edit checkpoint, each
        # registry holds four, so nothing is evicted by accident
        sd_registry = Registry(torch.device("cuda"), registry.model_root_dir)
        sd_paths, sd_served = serve_sd_path(smi, sd_registry)
        mark("phase 5 SD path")
        edit_paths, edit_served = serve_edit_path(smi, registry, sd_registry, unet_launches)
        mark("phase 5 edit path")
        checkpoint_paths, checkpoint_served = serve_checkpoint_path(smi)
        mark("phase 5 checkpoint path")
        adapter_paths, adapter_served = serve_adapter_path(smi, unet_launches)
        mark("phase 5 adapter path")
        batched_paths, batched_served = serve_batched_path(smi, unet_launches)
        mark("phase 5 batched path")
        cn_paths, cn_served = serve_controlnet_path(smi, unet_launches)
        mark("phase 5 ControlNet path")
        up_paths, up_served = serve_upscale_path(smi, unet_launches)
        mark("phase 5 upscale path")
        pre_paths, pre_served = serve_preprocessor_path(smi, unet_launches)
        mark("phase 5 preprocessor path")
        resume_paths, resume_served = serve_resume_path(smi, registry, sd_registry,
                                                        unet_launches)
        mark("phase 5 resume and cancel path")
        plane_paths, plane_served = serve_worker_plane_path(smi, registry, sd_registry,
                                                            unet_launches)
        mark("phase 5 worker-plane path")
        hive_paths, hive_served = serve_hive_plane_path(smi, registry, sd_registry,
                                                        unet_launches)
        mark("phase 5 hive-plane path")
        # beside the main path's resident SDXL pipelines
        k_paths, k_served = serve_kandinsky_path(smi)
        mark("phase 5 Kandinsky path")
        # (model, registry, canvas, CFG rows, parts) of phases 7 and 8
        calls = [(SDXL, registry, SIZE, 2, ("unet", "vae_decode", "vae_encode")),
                 *((model, sd_registry, size, 2, ("unet",)) for model, size in SD_CANVASES),
                 (REFINER, registry, SIZE, 2, ("unet",)),
                 (SD15_P2P, sd_registry, 512, 3, ("unet",))]
        e2e, profile = {}, {}
        for model, reg, size, rows, parts in calls:
            e2e[model] = end_to_end_bf16_check(reg.get_pipeline(model), size, parts, rows)
        mark("phase 7 end to end")
        for model, reg, size, rows, parts in calls:
            profile[model] = profile_main_path(reg.get_pipeline(model), size, parts=parts,
                                               rows=rows)
        # coalesced UNet calls: SDXL at 8 CFG rows (4 images), SD 1.5 at 16 (8)
        for model, reg, size, rows in ((SDXL, registry, SIZE, 8), (SD15, sd_registry, 512, 16)):
            profile[f"{model} at {rows} CFG rows"] = profile_main_path(
                reg.get_pipeline(model), size, parts=("unet",), rows=rows)
        for part in profile.values():
            log_profile(part, smi)
            check_one_launch_per_call(part)
        mark("phase 8 profile")
        flux_beside = serve_flux_beside_sd(smi, registry)
        mark("phase 5 Flux beside SDXL")
        # the Flux path measures with the card to itself: the SD registries
        # (the Flux bundles above with them), the detectors and the
        # safety checker go first
        from chiaswarm_tpu_torch.pipelines import aux_models, safety

        del registry, sd_registry, calls, reg
        aux_models.clear()
        safety._CHECKER = safety._CHECKER_KEY = None
        import gc

        gc.collect()
        torch.cuda.empty_cache()
        alive = Counter(type(o).__name__ for o in gc.get_objects()
                        if type(o).__name__ in ("SDPipeline", "LatentUpscalePipeline",
                                                "Registry"))
        check(_allocated_gib("cuda") < 8.0,
              f"{_allocated_gib('cuda'):.1f} GiB still allocated before the Flux path "
              f"(alive: {dict(alive)})")
        flux_paths, flux_served = serve_flux_path(smi)
        mark("phase 5 Flux path (with its phases 7 and 8)")
        k3_paths, k3_served = serve_kandinsky3_path(smi)
        mark("phase 5 Kandinsky 3 path (with the setup CLI)")
        cascade_paths, cascade_served = serve_cascade_path(smi)
        mark("phase 5 Stable Cascade path (with the setup CLI)")
        summary, shapes = measure({"txt2img": (N_JOBS, launches), **image_paths, **sd_paths,
                                   **edit_paths, **checkpoint_paths, **adapter_paths,
                                   **batched_paths, **cn_paths, **up_paths, **pre_paths,
                                   **resume_paths, **plane_paths, **hive_paths,
                                   **k_paths, **flux_paths, **k3_paths, **cascade_paths})
        mark("phase 6 measure")
        if opts.detail:
            path = Path(opts.detail)
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_text(json.dumps(
                {"card": smi, "tiny_sd": tiny_sd, "tiny_image": tiny_image,
                 "tiny_edit": tiny_edit, "tiny_adapters": tiny_adapters, "served": served,
                 "image_served": image_served, "sd_served": sd_served,
                 "edit_served": edit_served, "checkpoint_served": checkpoint_served,
                 "adapter_served": adapter_served, "batch_limits": limits,
                 "tiny_batched": tiny_batched, "batched_served": batched_served,
                 "controlnet_served": cn_served, "upscale_served": up_served,
                 "preprocessor_served": pre_served, "resume_served": resume_served,
                 "plane_served": plane_served, "hive_served": hive_served,
                 "tiny_flux": tiny_flux, "tiny_kandinsky": tiny_kandinsky,
                 "kandinsky_served": k_served,
                 "flux_beside_sdxl": flux_beside, "flux_served": flux_served,
                 "kandinsky3_served": k3_served, "cascade_served": cascade_served,
                 "kernels": summary,
                 "shapes": shapes, "end_to_end_bf16": e2e, "profile": profile}, indent=1,
                default=str))
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(sdaas_root, ignore_errors=True)
    log(f"[smoke] every phase passed in {time.perf_counter() - started:.1f}s")
    print(json.dumps({"kernels": summary}))
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
