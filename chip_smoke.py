#!/usr/bin/env python3
"""Drive the port's main path on one CUDA card and check every kernel on it.

    python3 chip_smoke.py          # from the repo root; builds on first use

Phases, each printing its own lines; any failure exits non-zero:

  1. card   : nvidia-smi name and power limit, torch and CUDA versions
  2. build  : nvcc builds src/repro_torch/csrc/*.cu for sm_90a; each
              attention kernel's registers (ptxas) and each cache-kernel
              block's occupancy from the library, which must equal
              attention_plan's model of it (kv_block_bytes, KV_REGISTERS);
              each norm kernel and fused norm-pass instantiation's
              registers and spill stores
  3. kernels: each CUDA kernel against its plain PyTorch version on the card,
              at the main paths' shapes (the CNNs' at batch 10, 100 and
              1024) and ragged ones, the dense kernel also at K on both
              sides of its split boundaries and at granite-8b's decode
              shapes; the Eq. 12 cancellation check and a LayerNorm row
              offset by 100, both against fp64; a dense row's bits
              independent of M (M 6, 100, 1024: three plans); the batched
              kernel with kept-row counts (skipped rows +0, the rest bit
              for bit the kernel without them); the cache kernels' bit
              contract: the rows of one slot from one 512-row call come
              out bit for bit in chunks of 128 and at Tq 1 in a batch of
              4, through shuffled pages of 16 rows and under every
              cluster size (kernels/pfp_attention.py attention_plan), at
              granite-8b's widths and at musicgen-medium's (24 / 24 heads
              of 64); the cache kernels also at musicgen's decode step and
              prefill chunk; the attention kernel without a cache (row 9)
              at granite's and musicgen's forward shapes and at ragged ones
              (Tq and Tk on no multiple of its block or tile, Tq below and
              above Tk, G 4 and 1, head_dim 16, 64 and 128, causal and
              not), each twice with the same bits; musicgen's LayerNorm,
              gelu and dense shapes (forward and decode step); the
              activation (five kinds) and the max pool beyond the main-path
              shapes: stress inputs (point masses, |mu| / sd up to 40, var
              1e4, mu +-90), operands 1-3 floats off 16 bytes, the pool on
              SRM input bit for bit to_var() and the VAR kernel, the same
              bits under other launch plans, and each kernel's error
              against fp64 no worse than 4x its plain version's; the norms
              (rows 6 and 7) at the decode shapes (4, 1536), (4, 2048) and
              (4, 4096) and at ragged widths (333, 4097), VAR and SRM input,
              with and without an activation (LayerNorm with gelu), each
              also on operands 4 bytes off 16-byte alignment with the
              aligned call's bits; a norm row's bits equal at M 1, 4, 33
              and 2048 and unaligned (norm_m_independence_check); the
              LayerNorm row offset by 100 no further from fp64 than 4x the
              fp32 plain version (the centred spread)
  4. serving: LeNet-5 and MLP at full width (random weights from a seed,
              sigma_init 1e-3, converted with calibration factor 0.4) answer
              Dirty-MNIST batches of 100 per split with impl="kernel"; the
              logits are held against impl="eager" on the card, and every
              kernel must have launched during this phase
  5. lm     : granite-8b at full width (d_model 4096, 32 / 8 heads of 128,
              d_ff 14336, vocab 49152; the one cut: 2 layers of 36), random
              weights drawn on the card from a seed, answers requests of 4
              prompts of 512 token ids, one PFP forward each with
              impl="kernel": next token and Eq. 1-3 uncertainty at the last
              position. The logits are held against impl="eager", and the
              norm, GLU, attention, dense and activation kernels must have
              launched during this phase
  6. decode : granite-8b at the same width serves DECODE_REQUESTS requests
              (prompts of 256-512 token ids, 16-32 new tokens, both drawn
              from --seed) through DECODE_SLOTS slots with impl="kernel":
              the Batcher fills and evicts the slots, greedy tokens come
              with their MI and abstain flag from uncertainty_decode. Run
              twice: on DecodeStatePool (each prompt prefilled on its own,
              then lockstep decode with per-slot positions and cache_len)
              and on PagedDecodeStatePool (page size 16, prompts prefilled
              in chunks of 128 through decode_step and the page table).
              Both runs must give the same tokens and bit-identical
              last-step logits, launch the cache and paged attention
              kernels, keep the pools' invariants and leave no slot or page
              live; teacher-forced decode logits are held against
              impl="eager"
  7. times  : device times (CUDA graph replays between CUDA events) of
              each kernel at batch 10, 100 and 1024 and at the LM's shapes
              (the dense kernel also at a 4-slot decode step's shapes, the
              cache kernels at granite-8b's and deepseek-moe-16b's decode
              and at a prefill shape, each with a [plan] line), beside its
              plain version, a one-call PyTorch yardstick and its bound,
              plus its time per eager call and each dense call's plan;
              the empty kernel's time (csrc/pfp_floor.cu, the floor no
              launch goes under) beside each activation and pool time, with
              their bytes, issue and MUFU limits (SASS counts, ACT_SASS),
              and beside each norm time with its bytes limit (rows 6 and 7
              also at granite's, deepseek's and musicgen's 4-slot decode
              shapes);
              whole-model forwards, eager and captured in a CUDA graph
  8. profile: torch.profiler over each model's forwards and one decode
              step: device busy share, the device kernels a forward
              launches and the five that take the most device time
  9. moe    : deepseek-moe-16b at full width (d_model 2048, 16 heads of
              128, 64 routed experts top-6 plus 2 shared, d_ff 1408, vocab
              102400; the one cut: 3 of 28 layers, layer 0 dense and layers
              1-2 MoE), random weights drawn on the card from a seed.
              (a) 2 requests of 4 x 512 token ids, one PFP forward each
              with impl="kernel" (Eq. 12), logits held against
              impl="eager" after the two impls' routing is compared;
              (b) the same with formulation="var" (Eq. 7); the batched
              expert kernel must launch in each. (c) decode: 8 requests
              with prompts of PREFILL_CHUNK tokens (one prefill call of the
              same shape on both pools) through 4 slots on both pools, as
              in phase 6, with drop counts per pool, and once more on the
              contiguous pool with the empty-expert skip off (the same
              tokens and last-step logits bit for bit; experts holding a
              row per decode MoE call printed). Then the batched kernels'
              times at the MoE shapes and at the decode shapes with the
              median decode call's kept rows, the MoE forward eager and
              in a CUDA graph, and a profile of one forward and one decode
              step. Peak device memory is printed.
 10. audio  : musicgen-medium at full width and all 48 layers (d_model
              1536, 24 heads of 64 over 24 KV heads, d_ff 6144 ungated
              gelu, LayerNorm, sinusoidal positions, vocab 2048, frame
              embeddings in: no token table), random weights drawn on the
              card from a seed. A 4 x 512-frame forward with impl="kernel"
              must launch only the path's kernels (dense 289, layernorm 97,
              activation 48, attention 48) and give the eager impl's
              logits at MODEL_TOL, else meet the fp64 rule at every stage
              (the kernel impl no further from an fp64 eager forward than
              FP64_FACTOR times the eager impl; the errors are printed
              either way). AUDIO_PROMPTS prompts prefilled in chunks of
              PREFILL_CHUNK through decode_step and AUDIO_STEPS lockstep
              steps fed seeded frames, on DecodeStatePool and on
              PagedDecodeStatePool (pages of 16): every pass's logits bit
              for bit across the pools and at MODEL_TOL of the eager impl;
              a whole-prompt prefill against eager. Forward (eager, in a
              CUDA graph, profiled), prefill and step times, peak memory,
              and the kernels' times at the path's shapes (B=audio,
              audio-decode, decode-audio, chunk-audio)
 11. fused  : the fused norm -> dense -> activation kernel (row 8) against
              its plain version at ragged shapes (both norms, both input
              reps, the five activations, every tile) and, at granite's
              gate projection (2048, 4096, 14336) and its decode shape
              (4, 4096, 14336), every tile against the plain version and
              against the unfused kernel chain (bit for bit, or the largest
              ulp gap within NDA_TOL); repro_torch.tuning.autotune tunes
              granite-8b's fused units (full width, 2 layers: a 4 x 512
              forward and a 4-slot decode step) on the card into
              build/schedules/, timing each against the unfused chain, and
              the DB is reloaded. A copy of it with every entry set to fuse
              goes to build/schedules/ beside it. With fusion on and each
              DB, the 4 x 512 forward must consult the cache at every fused
              unit and, where the DB fuses the gate, hit it and launch the
              fused kernel once a layer in place of the gate's dense and
              activation (else the unfused chain), give the unfused
              forward's greedy tokens at every position and moments within
              NDA_TOL; the decode phase's requests through DecodeStatePool
              must give the unfused run's tokens, launching the fused
              kernel once per cache hit where the DB fuses the decode
              step's unit and not where it stays unfused. So the forced DB
              drives the fused kernel inside the model whatever the tuner
              chose. It prints whether the tuned DB fuses the forward and
              the decode step, each forward's fused launches, and one
              decode step's device busy unfused and fused by the tuned DB.
              Times: the forward eager and in a CUDA graph, fused by the
              tuned DB, fused at every unit and unfused; row 8 at the gate
              and decode shapes beside the unfused chain.

 12. train  : the paper's Table-1 pipeline on the card, as the reference's
              benchmarks/common.py trained_paper_models and
              bench_table1_quality.py run it at quick=False: the MLP
              784-100-100-10 and LeNet-5 (sigma_init 1e-3) SVI-trained on
              Dirty-MNIST (4000 images, batches of 100, 60 epochs, Adam
              3e-3, KLSchedule(0.25, 150), every eps from a seeded CUDA
              generator); DET accuracy; SVI-30 accuracy and MI-AUROC (OOD
              vs clean, 1000 images each); svi_to_pfp at each calibration
              factor of TABLE1_CANDIDATES, the PFP forward on the kernels
              (impl="kernel"), Eq. 11 with 30 samples, the factor with the
              best MI-AUROC. It fails unless the NLL halves, DET accuracy
              is above 0.6, |SVI - PFP| accuracy is under 0.08, PFP
              MI-AUROC is above 0.6, the calibrated kernel logits on the
              trained weights are no further from an fp64 eager forward
              than FP64_FACTOR times the fp32 eager impl's (formulations
              srm and var; the share outside MODEL_TOL of the eager impl
              is printed) and rows 1-4 launched. Then granite-8b at full
              width (2 of 36 layers): SVI train steps of Adam(1e-3,
              clip_norm=1.0) on TokenPipeline batches of 1 x 256 tokens;
              every loss and gradient norm finite, every parameter changed
              by step 1, step 1 run again from the same state and seed
              gives the same loss; step ms and peak memory printed

Then one JSON line of per-kernel numbers, the card's name and power limit,
and a last JSON line ``{"ok": true, "device": {...}}``. Full numbers go to
chiprun_out/chip_smoke.json.
"""
import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"

# Published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, fp32 SIMT flop/s.
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
# The SMs' issue rate (4 schedulers of 32 lanes: 128 thread-instructions a
# clock) and special-function rate (16 MUFU results a clock), at the SM
# clock nvidia-smi reports as clocks.max.sm (phase_card sets it; 1980 MHz
# on the H100 SXM).
SMS, ISSUE_LANES, MUFU_LANES = 132, 128, 16
SM_CLOCK_HZ = 1.98e9
DENSE_TOL = dict(rtol=1e-5, atol=1e-4)       # tests/test_kernels.py
ELEMENTWISE_TOL = dict(rtol=1e-5, atol=1e-5)
NORM_TOL = dict(rtol=1e-4, atol=1e-5)        # norms and attention
MODEL_TOL = dict(mean=(1e-3, 1e-4), var=(1e-2, 1e-5))  # test_impl_dispatch.py
BATCHES = (10, 100, 1024)
MAIN_BATCH = 100
CALIBRATION = 0.4
# (issued instructions, MUFU ops) per element of the activation kernel and
# per output of the max-pool kernel, counted from their SASS with
# tools/sass_counts.py (nvcc 12.8, sm_90a): the activation's float4 loop
# body over its 4 elements, the pool's vec-4 loop body over its 4 channels
# (the least a thread spends on one: no per-thread set-up in it). Recount
# when pfp_moments.cuh or pfp_maxpool.cu changes.
ACT_SASS = {"relu": (63, 3), "gelu": (230, 17), "silu": (134, 17),
            "tanh": (174, 17), "sigmoid": (126, 17)}
POOL_SASS = (205, 9)
SASS_KERNELS = ("activation", "maxpool2d")
FLOOR_MS = None   # the empty kernel's device ms a launch (phase_times)
NORM_OPS = {"rmsnorm": 8, "layernorm": 12}
SOFTMAX_OPS_PER_SCORE = 6   # scale, mask, max, exp, sum, square of p
# The LM serving phase: granite-8b at full width, cut to LM_LAYERS layers.
LM_ARCH = "granite-8b"
LM_LAYERS = 2
LM_BATCH, LM_SEQ, LM_REQUESTS = 4, 512, 2
CNN_KERNELS = ("dense", "dense_first_layer", "dense_var", "activation",
               "maxpool2d")
LM_KERNELS = ("dense", "activation", "rmsnorm", "glu_product", "attention")
# The decode phase: DECODE_REQUESTS requests through DECODE_SLOTS slots of
# DECODE_MAX_LEN cache rows, on the contiguous and on the paged pool.
DECODE_SLOTS, DECODE_REQUESTS, DECODE_MAX_LEN = 4, 8, 1024
PROMPT_LENS, NEW_TOKENS = (256, 512), (16, 32)
PAGE_SIZE, PREFILL_CHUNK = 16, 128
TEACHER_FORCED = (2, 8)   # requests, tokens fed after the prompt
DECODE_KERNELS = ("dense", "activation", "rmsnorm", "glu_product",
                  "attention_cache", "attention_paged")
CACHE_KERNELS = ("attention_cache", "attention_paged")
# Cache attention shapes: (B, H, Hkv, Tq, S, D, q_start, kv_len, window);
# a paged shape appends the page size. S is the cache length (the logical
# one when paged).
CACHE_DECODE = (4, 32, 8, 1, 1024, 128, (0, 340, 681, 1023),
                (1, 341, 682, 1024), None)
CACHE_PREFILL = (4, 32, 8, 512, 1024, 128, (0, 256, 0, 256),
                 (512, 768, 512, 768), None)
# deepseek-moe-16b's decode: 16 query heads over 16 KV heads (G 1).
CACHE_DECODE_MOE = (4, 16, 16, 1, 1024, 128, (0, 340, 681, 1023),
                    (1, 341, 682, 1024), None)
# musicgen-medium's: 24 query heads of 64 over 24 KV heads (G 1), a 4-slot
# decode step and a prefill chunk of one slot.
CACHE_DECODE_AUDIO = (4, 24, 24, 1, 1024, 64, (0, 340, 681, 1023),
                      (1, 341, 682, 1024), None)
CACHE_CHUNK_AUDIO = (1, 24, 24, 128, 1024, 64, (384,), (512,), None)
CACHE_CHECKS = {
    "decode": CACHE_DECODE,
    "prefill chunk": CACHE_PREFILL,
    "window": (4, 32, 8, 64, 1024, 128, (100, 500, 0, 900),
               (164, 564, 64, 964), 128),
    "kv_len 0": (4, 32, 8, 1, 1024, 128, (0, 10, 0, 500), (0, 11, 0, 501),
                 None),
    "head_dim 16": (2, 4, 2, 7, 100, 16, (0, 50), (7, 57), None),
    "decode-moe": CACHE_DECODE_MOE,
    "audio decode": CACHE_DECODE_AUDIO,
    "audio chunk": CACHE_CHUNK_AUDIO,
    "head_dim 64 window": (2, 8, 2, 37, 300, 64, (10, 250), (47, 287), 50),
}
CHECK_PAGE_SIZES = (1, 16, 24)
# The norms' checks: the 4-slot decode shapes of musicgen-medium,
# deepseek-moe-16b and granite-8b, and ragged widths.
NORM_DECODE = ((DECODE_SLOTS, 1536), (DECODE_SLOTS, 2048),
               (DECODE_SLOTS, 4096))
NORM_RAGGED = ((7, 333), (3, 4097))
# The MoE phase: deepseek-moe-16b at full width, cut to MOE_LAYERS layers
# (layer 0 dense, the rest MoE), requests as in the LM phase.
MOE_ARCH = "deepseek-moe-16b"
MOE_LAYERS = 3
MOE_KERNELS = ("dense", "activation", "rmsnorm", "glu_product", "attention",
               "dense_batched")
MOE_DECODE_KERNELS = ("dense", "activation", "rmsnorm", "glu_product",
                      "attention_cache", "attention_paged", "dense_batched")
BATCHED_KERNELS = ("dense_batched", "dense_batched_first_layer",
                   "dense_batched_var")
# Batched dense shapes (E, C, K, N): the expert up / gate and down products
# at 4 x 512 tokens (capacity 240) and at a 4-slot decode step (capacity 6).
MOE_UP, MOE_DOWN = (64, 240, 2048, 1408), (64, 240, 1408, 2048)
MOE_DECODE_UP, MOE_DECODE_DOWN = (64, 6, 2048, 1408), (64, 6, 1408, 2048)
MOE_SHAPES = (MOE_UP, MOE_DOWN, MOE_DECODE_UP, MOE_DECODE_DOWN)
NEAR_TIE = 1e-4   # a routing mismatch at a larger top-k margin is a fault
# The audio phase: musicgen-medium at full width and depth (48 layers),
# frame embeddings in (no token table). DECODE_SLOTS prompts of
# AUDIO_PROMPTS frames, each prefilled in chunks of PREFILL_CHUNK through
# decode_step on both pools, then AUDIO_STEPS lockstep steps.
AUDIO_ARCH = "musicgen-medium"
AUDIO_KERNELS = ("dense", "activation", "layernorm", "attention")
AUDIO_DECODE_KERNELS = ("dense", "activation", "layernorm",
                        "attention_cache", "attention_paged")
AUDIO_PROMPTS = (512, 437, 300, 129)
AUDIO_STEPS = 32
# The fused phase: granite's gate projection (norm -> dense -> silu) at a
# 4 x 512 forward and a 4-slot decode step, with a schedule DB the
# autotuner writes on the card.
NDA_TOL = dict(rtol=1e-3, atol=5e-4)   # tests/test_impl_dispatch.py _NDA_TOL
FUSED_CHECK_SHAPES = ((37, 200, 130), (4, 4096, 1000))
SCHEDULE_DB = ROOT / "build" / "schedules" / "granite-8b.json"
# The tuned DB with every entry set to fuse (the fused phase writes it), and
# the launch-count label of the fused runs with each DB.
FORCED_DB = SCHEDULE_DB.with_name("granite-8b.forced.json")
FUSED_RUNS = {"tuned": "fused", "forced": "fused_forced"}
# The train phase: the paper's Table-1 pipeline as the reference's
# benchmarks/common.py trained_paper_models and bench_table1_quality.py run
# it at quick=False (SVI training, SVI-30, calibrated PFP with Eq. 11), then
# SVI train steps of granite-8b at full width (LM_LAYERS layers) as its
# launch/programs.py train program sets them (Adam 1e-3 clipped at 1.0,
# num_data batch x seq x 1000, KL annealed over 1000 steps; fp32, no remat).
TRAIN_N, EVAL_N, TRAIN_EPOCHS, TRAIN_BATCH = 4000, 1000, 60, 100
TABLE1_SAMPLES = 30
TABLE1_CANDIDATES = (0.1, 0.2, 0.3, 0.4, 0.5, 0.7, 1.0, 1.5, 2.0)
FP64_FACTOR = 4   # kernel impl's error from fp64 against the eager impl's
LM_TRAIN_SEQ, LM_TRAIN_STEPS = 256, 3
# K on both sides of the dense kernel's split boundaries (kernels/pfp_dense.py
# split_k at N 100: 1 to K 64, 2 to 96, 3 from 97, 7 at 784, 8 from 785).
SPLIT_CHECK_K = (1, 17, 64, 65, 96, 97, 127, 129, 783, 784, 785)

KERNELS = {
    "dense": ("src/repro_torch/csrc/pfp_dense.cu",
              "src/repro/kernels/pfp_dense.py:246"),
    "dense_first_layer": ("src/repro_torch/csrc/pfp_dense.cu",
                          "src/repro/kernels/pfp_dense.py:246"),
    "dense_var": ("src/repro_torch/csrc/pfp_dense.cu",
                  "src/repro/kernels/pfp_dense.py:323"),
    "activation": ("src/repro_torch/csrc/pfp_activations.cu",
                   "src/repro/kernels/pfp_activations.py:101"),
    "maxpool2d": ("src/repro_torch/csrc/pfp_maxpool.cu",
                  "src/repro/kernels/pfp_maxpool.py:59"),
    "glu_product": ("src/repro_torch/csrc/pfp_activations.cu",
                    "src/repro/kernels/pfp_activations.py:132"),
    "rmsnorm": ("src/repro_torch/csrc/pfp_norms.cu",
                "src/repro/kernels/pfp_norms.py:84"),
    "layernorm": ("src/repro_torch/csrc/pfp_norms.cu",
                  "src/repro/kernels/pfp_norms.py:101"),
    "attention": ("src/repro_torch/csrc/pfp_attention.cu",
                  "src/repro/kernels/pfp_attention.py:171"),
    "attention_cache": ("src/repro_torch/csrc/pfp_attention.cu",
                        "src/repro/kernels/pfp_attention.py:345"),
    "attention_paged": ("src/repro_torch/csrc/pfp_attention.cu",
                        "src/repro/kernels/pfp_attention.py:420"),
    "dense_batched": ("src/repro_torch/csrc/pfp_dense.cu",
                      "src/repro/kernels/pfp_moe.py:210"),
    "dense_batched_first_layer": ("src/repro_torch/csrc/pfp_dense.cu",
                                  "src/repro/kernels/pfp_moe.py:210"),
    "dense_batched_var": ("src/repro_torch/csrc/pfp_dense.cu",
                          "src/repro/kernels/pfp_moe.py:291"),
    "norm_dense_act": ("src/repro_torch/csrc/pfp_fused.cu",
                       "src/repro/kernels/pfp_fused.py:128"),
}
# What ``library_ms`` times, where one PyTorch call computes the same work.
LIBRARY = {
    "dense": "torch.bmm of the stacked fp32 operand pairs (products only)",
    "activation": "none: no single call computes a Gaussian's moments "
                  "through the activation (the closed form or 8 "
                  "Gauss-Hermite nodes)",
    "maxpool2d": "none: no single call computes Clark's moments of a max "
                 "of Gaussians",
    "rmsnorm": "none: F.rms_norm has no delta-method variance",
    "layernorm": "none: F.layer_norm has no delta-method variance",
    "dense_first_layer": "torch.bmm of the stacked fp32 operand pairs",
    "dense_var": "torch.bmm of the stacked fp32 operand pairs",
    "glu_product": "torch.mul of the stacked (mu, srm) operand pairs",
    "attention": "scaled_dot_product_attention on the means: mean half only",
    "attention_cache": "scaled_dot_product_attention on the means with a "
                       "boolean mask: mean half only",
    "attention_paged": "none: no single call (a gather of the pages and "
                       "SDPA are two)",
    "dense_batched": "torch.bmm of the stacked fp32 operand pairs of all "
                     "experts (products only)",
    "dense_batched_first_layer": "torch.bmm of the stacked fp32 operand "
                                 "pairs of all experts",
    "dense_batched_var": "torch.bmm of the stacked fp32 operand pairs of all "
                         "experts",
    "norm_dense_act": "none: no single call (a PFP norm, three products and "
                      "the moment functions)",
}


def fail(msg):
    raise SystemExit(f"FAIL: {msg}")


# ---------------------------------------------------------------------------
# Main-path calls: (kernel, shape) per forward
# ---------------------------------------------------------------------------
def main_path_calls(batch, formulation="srm"):
    """Every kernel call of one LeNet-5 and one MLP PFP forward at ``batch``.
    Dense shapes are (M, K, N); activation and pool shapes the tensor's."""
    dense = "dense" if formulation == "srm" else "dense_var"
    b = batch
    return [
        # LeNet-5
        ("dense_first_layer", (784 * b, 25, 6)),
        ("activation", (b, 28, 28, 6)),
        ("maxpool2d", (b, 28, 28, 6)),
        (dense, (196 * b, 150, 16)),
        ("activation", (b, 14, 14, 16)),
        ("maxpool2d", (b, 14, 14, 16)),
        (dense, (b, 784, 120)),
        ("activation", (b, 120)),
        (dense, (b, 120, 84)),
        ("activation", (b, 84)),
        (dense, (b, 84, 10)),
        # MLP
        ("dense_first_layer", (b, 784, 100)),
        ("activation", (b, 100)),
        (dense, (b, 100, 100)),
        ("activation", (b, 100)),
        (dense, (b, 100, 10)),
    ]


def lm_config():
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(LM_ARCH), num_layers=LM_LAYERS,
                               sigma_init=1e-3)


def lm_path_calls(cfg):
    """Every kernel call of one LM PFP forward (impl="kernel", srm) on
    LM_BATCH x LM_SEQ tokens. Dense shapes are (M, K, N); norm and GLU
    shapes (rows, width); attention (B, H, Hkv, Tq, Tk, D, causal)."""
    batch, seq = LM_BATCH, LM_SEQ
    m, d, f = batch * seq, cfg.d_model, cfg.d_ff
    kv = cfg.num_kv_heads * cfg.head_dim
    block = [
        ("rmsnorm", (m, d)),
        ("dense", (m, d, cfg.attn_dim)), ("dense", (m, d, kv)),
        ("dense", (m, d, kv)),
        ("attention", (batch, cfg.num_heads, cfg.num_kv_heads, seq, seq,
                       cfg.head_dim, True)),
        ("dense", (m, cfg.attn_dim, d)),
        ("rmsnorm", (m, d)),
        ("dense", (m, d, f)), ("dense", (m, d, f)),   # up, gate
        ("activation", ("silu", m, f)), ("glu_product", (m, f)),
        ("dense", (m, f, d)),
    ]
    return block * cfg.num_layers + [("rmsnorm", (m, d)),
                                     ("dense", (m, d, cfg.vocab_size))]


def lm_decode_calls(cfg):
    """The dense kernel's calls in one LM decode step of DECODE_SLOTS
    slots (fusion off): (M, K, N)."""
    m, d, f = DECODE_SLOTS, cfg.d_model, cfg.d_ff
    kv = cfg.num_kv_heads * cfg.head_dim
    block = [(m, d, cfg.attn_dim), (m, d, kv), (m, d, kv),
             (m, cfg.attn_dim, d), (m, d, f), (m, d, f), (m, f, d)]
    return block * cfg.num_layers + [(m, d, cfg.vocab_size)]


def norm_decode_calls(cfg):
    """The RMSNorm's calls in one LM decode step of DECODE_SLOTS slots
    (fusion off): two a layer and the final norm, (rows, width)."""
    return [(DECODE_SLOTS, cfg.d_model)] * (2 * cfg.num_layers + 1)


def lm_chunk_calls(cfg):
    """The dense kernel's calls in one paged prefill chunk of
    PREFILL_CHUNK tokens (one prompt): (M, K, N)."""
    return [(PREFILL_CHUNK, *shape[1:]) for kernel, shape in lm_path_calls(cfg)
            if kernel == "dense"]


def audio_config():
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(AUDIO_ARCH), sigma_init=1e-3)


def audio_path_calls(cfg, decode=False):
    """Every kernel call of one musicgen-medium PFP forward (impl="kernel",
    srm) on LM_BATCH x LM_SEQ frames, or with ``decode`` of one decode step
    of DECODE_SLOTS slots but its cache attention (CACHE_DECODE_AUDIO, a
    call a layer). Shapes as in lm_path_calls; the activation leads with its
    kind."""
    m = DECODE_SLOTS if decode else LM_BATCH * LM_SEQ
    d, f = cfg.d_model, cfg.d_ff
    kv = cfg.num_kv_heads * cfg.head_dim
    attention = [] if decode else [
        ("attention", (LM_BATCH, cfg.num_heads, cfg.num_kv_heads, LM_SEQ,
                       LM_SEQ, cfg.head_dim, True))]
    block = [("layernorm", (m, d)),
             ("dense", (m, d, cfg.attn_dim)), ("dense", (m, d, kv)),
             ("dense", (m, d, kv)), *attention,
             ("dense", (m, cfg.attn_dim, d)),
             ("layernorm", (m, d)),
             ("dense", (m, d, f)), ("activation", ("gelu", m, f)),
             ("dense", (m, f, d))]
    return block * cfg.num_layers + [("layernorm", (m, d)),
                                     ("dense", (m, d, cfg.vocab_size))]


def attention_plan_line(label, kernel, shape):
    """Print the cache kernel's launch plan at ``shape``; return it."""
    from repro_torch.kernels.pfp_attention import (SEGMENT, attention_plan,
                                                   plan_blocks, segments)
    b, h, hkv, tq, s, d = shape[:6]
    cap = s if kernel == "attention_cache" else -(-s // shape[9]) * shape[9]
    plan = attention_plan(b, h, hkv, tq, cap, d)
    fold = ("partials folded by rank 0 over distributed shared memory"
            if plan.cluster > 1 else "segments folded in turn by the block")
    print(f"[plan] {kernel} B={label}: segment {SEGMENT} keys, "
          f"{segments(cap)} segments of {cap} keys, block rows "
          f"{plan.block_rows}, cluster {plan.cluster}, "
          f"{plan_blocks(plan, b, h, hkv, tq)} blocks, {fold}")
    return list(plan)


def dense_plan_of(kernel, shape):
    """The plan ``kernels/pfp_dense.py`` gives a dense kernel's call, as
    (split, bn, tn, tm, stages); None for the other kernels."""
    from repro_torch.kernels.pfp_dense import dense_plan
    if not kernel.startswith("dense"):
        return None
    mode = 2 if kernel.endswith("_var") else 1 if "first" in kernel else 0
    if kernel in BATCHED_KERNELS:
        e, m, k, n = shape
        return tuple(dense_plan(m, n, k, e, mode))
    m, k, n = shape
    return tuple(dense_plan(m, n, k, 1, mode))


def _valid_pairs(tq, tk, causal):
    """(query, key) pairs with a valid key: right-aligned causality."""
    if not causal:
        return tq * tk
    return sum(min(tk, max(0, i + tk - tq + 1)) for i in range(tq))


def _cache_pairs(shape):
    """For the cache kernels: (keys read, valid (query row, key) pairs)
    over the batch, from this shape's q_start, kv_len and window. A key
    is read if it is valid for some query row of its batch row."""
    _, _, _, tq, s, _, q_start, kv_len, window = shape[:9]
    keys = pairs = 0
    for qs, kl in zip(q_start, kv_len):
        kl = min(max(kl, 0), s)
        first = 0 if window is None else max(0, qs - window + 1)
        keys += max(0, min(kl, qs + tq) - first)
        for pos in range(qs, qs + tq):
            lo = 0 if window is None else max(0, pos - window + 1)
            pairs += max(0, min(kl, pos + 1) - lo)
    return keys, pairs


def work(kernel, shape, rows=None):
    """(bytes, fp32 operations) the function needs: each input read once,
    each output written once (the activation and the max pool count their
    operations as SASS instructions, in limits()); attention counts the
    valid scores only, and
    the cache kernels the K / V rows that some query row can see. For the
    batched dense with ``rows`` (kept rows per expert), only the experts
    that hold a row: their weights, their kept rows' inputs and products,
    and every output (the zeros are written too)."""
    if kernel in CACHE_KERNELS:
        b, h, hkv, tq, s, d = shape[:6]
        keys, pairs = _cache_pairs(shape)
        nbytes = 4 * (3 * b * h * tq * d + 3 * hkv * keys * d + 2 * b)
        if kernel == "attention_paged":
            nbytes += 4 * b * -(-s // shape[9])   # the page table
        return nbytes, h * pairs * (6 * d + SOFTMAX_OPS_PER_SCORE)
    if kernel == "attention":
        b, h, hkv, tq, tk, d, causal = shape
        nbytes = 4 * (3 * b * h * tq * d + 3 * b * hkv * tk * d)
        pairs = b * h * _valid_pairs(tq, tk, causal)
        return nbytes, pairs * (6 * d + SOFTMAX_OPS_PER_SCORE)
    if kernel == "norm_dense_act":   # rmsnorm, Eq. 12 and silu
        m, k, n = shape
        return (4 * (2 * m * k + k + 2 * k * n + 2 * m * n),
                6 * m * n * k + NORM_OPS["rmsnorm"] * m * k
                + 2 * ACT_SASS["silu"][0] * m * n)   # an issue slot: 2 flops
    if kernel in NORM_OPS:
        rows, d = shape
        vectors = 2 if kernel == "layernorm" else 1
        return 16 * rows * d + 4 * vectors * d, NORM_OPS[kernel] * rows * d
    if kernel == "glu_product":
        rows, n = shape
        return 24 * rows * n, 2 * rows * n
    if kernel in BATCHED_KERNELS:
        e, c, k, n = shape
        nbytes = ops = 0
        for r in ([c] * e if rows is None else rows):
            if r:
                b, o = work(kernel.replace("_batched", ""), (r, k, n))
                nbytes, ops = nbytes + b, ops + o
            nbytes += 8 * (c - r) * n
        return nbytes, ops
    if kernel.startswith("dense"):
        m, k, n = shape
        if kernel == "dense_first_layer":
            return 4 * (m * k + 2 * k * n + 2 * m * n), 4 * m * n * k + m * k
        products = 3 if kernel == "dense" else 4
        return (4 * (2 * m * k + 2 * k * n + 2 * m * n),
                2 * products * m * n * k + m * k + k * n + m * n)
    _, numel = _elementwise(kernel, shape)
    if kernel == "activation":
        return 16 * numel, 0
    return 4 * (2 * numel + 2 * (numel // 4)), 0


def _elementwise(kernel, shape):
    """(kind, elements) of an activation or max-pool call."""
    kind, dims = _activation_kind(kernel, shape)
    numel = 1
    for d in dims:
        numel *= d
    return kind, numel


def limits(kernel, shape, rows=None):
    """{limit: ms}: the least time for the call's work by each limit of the
    card. Every kernel: its bytes over HBM's rate. The activation and the
    max pool: their issued instructions over the SMs' issue rate and their
    MUFU ops over the special-function rate (SASS counts, ACT_SASS and
    POOL_SASS). The rest: fp32 operations over the fp32 peak."""
    nbytes, ops = work(kernel, shape, rows)
    out = {"bytes": nbytes / PEAK_BYTES * 1e3}
    if kernel in SASS_KERNELS:
        kind, numel = _elementwise(kernel, shape)
        count = numel if kernel == "activation" else numel // 4
        instr, mufu = ACT_SASS[kind] if kernel == "activation" else POOL_SASS
        out["issue"] = count * instr / (SMS * ISSUE_LANES * SM_CLOCK_HZ) * 1e3
        out["mufu"] = count * mufu / (SMS * MUFU_LANES * SM_CLOCK_HZ) * 1e3
    else:
        out["operations"] = ops / PEAK_FP32 * 1e3
    return out


def _bound(lim):
    """(bound ms, bound_by, the limit that binds) of a limits() dict:
    issue and MUFU bounds are operations bounds."""
    limit = max(lim, key=lim.get)
    return lim[limit], ("bytes" if limit == "bytes" else "operations"), limit


def _activation_kind(kernel, shape):
    """An activation shape may lead with its kind ("silu", rows, cols);
    without one it is relu. Returns (kind, dims)."""
    if kernel == "activation" and isinstance(shape[0], str):
        return shape[0], shape[1:]
    return "relu", shape


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------
def gaussian(shape, seed, device, scale=1.0, on_device=False):
    """(mean, var) drawn from ``seed`` on the CPU, or on ``device``."""
    import torch
    g = torch.Generator(device=device if on_device else "cpu").manual_seed(
        seed)
    mu = scale * torch.randn(shape, generator=g, device=g.device)
    var = scale * torch.nn.functional.softplus(
        torch.randn(shape, generator=g, device=g.device))
    return mu.to(device), var.to(device)


def paged_from_cache(caches, kv_len, ps, seed, device):
    """Shuffled page pools holding the rows of contiguous caches
    (B, Hkv, S, D): logical page j of batch b at pool row table[b, j];
    table slots past a row's kv_len point at the trash page 0, and page 0
    and two spare pages hold junk. Returns (pools, table)."""
    import torch
    b, hkv, s, d = caches[0].shape
    p = -(-s // ps)
    used = torch.zeros((b, p), dtype=torch.bool)
    for bi, n in enumerate(kv_len):
        used[bi, :(n + ps - 1) // ps] = True
    g = torch.Generator().manual_seed(seed)
    n_used = int(used.sum())
    table = torch.zeros((b, p), dtype=torch.int32)
    table[used] = (torch.randperm(n_used + 2, generator=g)[:n_used] + 1).int()
    table, used = table.to(device), used.to(device)
    pools = []
    for cache in caches:
        rows = torch.nn.functional.pad(cache, (0, 0, 0, p * ps - s))
        pages = rows.reshape(b, hkv, p, ps, d).transpose(1, 2)
        pool = torch.randn((n_used + 3, hkv, ps, d), generator=g).to(device)
        pool[table[used].long()] = pages[used]
        pools.append(pool)
    return pools, table


def operands(kernel, shape, seed, device):
    """Kernel arguments on ``device`` for one call."""
    import torch
    if kernel in CACHE_KERNELS:
        b, h, hkv, tq, s, d, q_start, kv_len, window = shape[:9]
        q, _ = gaussian((b, h, tq, d), seed, device)
        k, _ = gaussian((b, hkv, s, d), seed + 1, device)
        vm, vv = gaussian((b, hkv, s, d), seed + 2, device)
        ints = [torch.tensor(v, dtype=torch.int32, device=device)
                for v in (q_start, kv_len)]
        if kernel == "attention_cache":
            return (q, k, vm, vv, *ints, d ** -0.5, window)
        pools, table = paged_from_cache((k, vm, vv), kv_len, shape[9],
                                        seed + 3, device)
        return (q, *pools, table, *ints, d ** -0.5, window)
    if kernel == "attention":
        b, h, hkv, tq, tk, d, causal = shape
        q, _ = gaussian((b, h, tq, d), seed, device)
        k, _ = gaussian((b, hkv, tk, d), seed + 1, device)
        vm, vv = gaussian((b, hkv, tk, d), seed + 2, device)
        return (q, k, vm, vv, d ** -0.5, causal)
    if kernel in NORM_OPS:
        rows, d = shape
        mu, var = gaussian((rows, d), seed, device)
        g = torch.Generator(device="cpu").manual_seed(seed + 1)
        gain = (1.0 + 0.1 * torch.randn((2, d), generator=g)).to(device)
        return (mu, var, gain[0]) + ((gain[1],) if kernel == "layernorm"
                                     else ())
    if kernel == "glu_product":
        mu_a, var_a = gaussian(shape, seed, device)
        mu_b, var_b = gaussian(shape, seed + 1, device)
        return (mu_a, var_a + mu_a * mu_a, mu_b, var_b + mu_b * mu_b)
    if kernel == "norm_dense_act":
        # The gate projection: rmsnorm of a VAR input, silu; the schedule
        # the global cache holds for the shape (None: the default tile).
        from repro_torch.tuning import cache as tcache
        m, k, n = shape
        mu, var = gaussian((m, k), seed, device)
        g = torch.Generator(device="cpu").manual_seed(seed + 1)
        gain = (1.0 + 0.1 * torch.randn(k, generator=g)).to(device)
        mw, vw = gaussian((k, n), seed + 2, device, 0.1, on_device=True)
        sched = tcache.global_cache().get(kernel, shape, "float32",
                                          tcache.default_backend(device))
        return (mu, var, gain, None, mw, vw + mw * mw, sched)
    if kernel.startswith("dense"):
        if kernel in BATCHED_KERNELS:
            e, m, k, n = shape
            # Drawn on the card: the expert stacks hold 10^8 weights.
            mx, vx = gaussian((e, m, k), seed, device, on_device=True)
            mw, vw = gaussian((e, k, n), seed + 1, device, 0.1,
                              on_device=True)
        else:
            m, k, n = shape
            mx, vx = gaussian((m, k), seed, device)
            mw, vw = gaussian((k, n), seed + 1, device, 0.1)
        kernel = kernel.replace("_batched", "")
        if kernel == "dense":
            return (mx, vx + mx * mx, mw, vw + mw * mw)
        if kernel == "dense_var":
            return (mx, vx, mw, vw)
        return (mx, mx, mw, vw)
    kind, dims = _activation_kind(kernel, shape)
    mu, var = gaussian(dims, seed, device)
    if kernel == "activation":
        return (mu, var, kind)
    # The pool as the CNN path calls it: on an activation's SRM output.
    return (mu, var + mu * mu, "srm")


def run_kernel(kernel, args, rows=None):
    from repro_torch.kernels import ops
    if kernel == "norm_dense_act":
        return ops.pfp_norm_dense_act(*args[:6], schedule=args[6])
    if kernel == "dense_batched":
        return ops.pfp_dense_batched(*args, rows=rows)
    if kernel == "dense_batched_first_layer":
        return ops.pfp_dense_batched(*args, first_layer=True, rows=rows)
    if kernel == "dense_batched_var":
        return ops.pfp_dense_batched_var(*args, rows=rows)
    if kernel == "dense":
        return ops.pfp_dense(*args)
    if kernel == "dense_first_layer":
        return ops.pfp_dense(*args, first_layer=True)
    if kernel == "dense_var":
        return ops.pfp_dense_var(*args)
    if kernel == "activation":
        return ops.pfp_activation(args[0], args[1], kind=args[2])
    if kernel == "rmsnorm":
        return ops.pfp_rmsnorm(*args)
    if kernel == "layernorm":
        return ops.pfp_layernorm(*args)
    if kernel == "glu_product":
        return ops.pfp_glu_product(*args)
    if kernel == "attention":
        return ops.pfp_attention(*args[:4], scale=args[4], causal=args[5])
    if kernel == "attention_cache":
        return ops.pfp_attention_cache(*args[:6], scale=args[6],
                                       window=args[7])
    if kernel == "attention_paged":
        return ops.pfp_attention_paged(*args[:7], scale=args[7],
                                       window=args[8])
    return ops.pfp_maxpool2d(args[0], args[1], rep=args[2])


def run_plain(kernel, args, rows=None):
    from repro_torch.kernels import ref
    if kernel == "norm_dense_act":
        return ref.pfp_norm_dense_act_ref(*args[:6])
    if kernel == "dense_batched":
        return ref.pfp_dense_batched_ref(*args, rows=rows)
    if kernel == "dense_batched_first_layer":
        return ref.pfp_dense_batched_first_layer_ref(args[0], *args[2:],
                                                     rows=rows)
    if kernel == "dense_batched_var":
        return ref.pfp_dense_batched_var_ref(*args, rows=rows)
    if kernel == "dense":
        return ref.pfp_dense_ref(*args)
    if kernel == "dense_first_layer":
        return ref.pfp_dense_first_layer_ref(args[0], args[2], args[3])
    if kernel == "dense_var":
        return ref.pfp_dense_var_ref(*args)
    if kernel == "activation":
        return ref.pfp_activation_ref(*args)
    if kernel == "rmsnorm":
        return ref.pfp_rmsnorm_ref(*args)
    if kernel == "layernorm":
        return ref.pfp_layernorm_ref(*args)
    if kernel == "glu_product":
        return ref.pfp_glu_ref(*args)
    if kernel == "attention":
        return ref.pfp_attention_ref(*args)
    if kernel == "attention_cache":
        return ref.pfp_attention_cache_ref(*args[:7], window=args[7])
    if kernel == "attention_paged":
        return ref.pfp_attention_paged_ref(*args[:8], window=args[8])
    mu, second, rep = args
    return ref.pfp_maxpool2d_ref(
        mu, second - mu * mu if rep == "srm" else second)


def library_call(kernel, args):
    """One PyTorch call computing the same products, or None. For the dense
    kernels: one fp32 torch.bmm (TF32 off) over the stacked operand pairs of
    the formulation, without the final elementwise combine. For attention:
    scaled_dot_product_attention on the means, which is the mean half only
    (no variance output). For the GLU: one torch.mul of the stacked
    (mu, srm) pairs. For the KV-cache kernel: the same SDPA with a boolean
    mask of the valid (query, key) pairs. No single call computes a PFP
    norm (F.rms_norm and F.layer_norm have no delta-method variance) or
    paged attention (a gather of the pages and SDPA are two)."""
    import torch
    if kernel == "attention_cache":
        q, k, vm, _, q_start, kv_len, scale, window = args
        tq, s = q.shape[2], k.shape[2]
        pos = q_start[:, None] + torch.arange(tq, device=q.device)
        j = torch.arange(s, device=q.device)
        mask = (j <= pos[..., None]) & (j < kv_len[:, None, None])
        if window is not None:
            mask &= j > pos[..., None] - window
        mask = mask[:, None]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        return lambda: sdpa(q, k, vm, attn_mask=mask, scale=scale,
                            enable_gqa=True)
    if kernel == "attention":
        q, k, vm, _, scale, causal = args
        sdpa = torch.nn.functional.scaled_dot_product_attention
        return lambda: sdpa(q, k, vm, is_causal=causal, scale=scale,
                            enable_gqa=True)
    if kernel == "glu_product":
        mu_a, srm_a, mu_b, srm_b = args
        a = torch.stack([mu_a, srm_a])
        b = torch.stack([mu_b, srm_b])
        return lambda: torch.mul(a, b)
    if not kernel.startswith("dense"):
        return None
    xa, xb, wa, wb = args
    kernel = kernel.replace("_batched", "")
    if kernel == "dense":
        a, b = [xa, xb, xa * xa], [wa, wb, wa * wa]
    elif kernel == "dense_var":
        a, b = [xa, xb, xa * xa, xb], [wa, wa * wa, wb, wb]
    else:
        a, b = [xa, xa * xa], [wa, wb]
    # One batch of products; a batched kernel's expert axis joins it.
    a, b = (torch.stack(t).flatten(0, -3) for t in (a, b))
    return lambda: torch.bmm(a, b)


def time_ms(fn, iters=30, warmup=3):
    """Mean time per call over ``iters`` back-to-back calls (CUDA events).
    Where the host issues calls more slowly than the device runs them,
    this is the host's time per call."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, inner=10, replays=5):
    """Device time per call: ``inner`` calls captured in one CUDA graph,
    replayed ``replays`` times between CUDA events, so no host work sits
    between the launches. Inputs stay where the previous call left them
    (in L2 when they fit), as between the layers of one forward."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (replays * inner)
    del graph
    return ms


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------
def phase_card():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"[card] {card}")
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60).stdout.split()
    global SM_CLOCK_HZ
    if clock and clock[0].isdigit():
        SM_CLOCK_HZ = float(clock[0]) * 1e6
    print(f"[card] SM clock (clocks.max.sm) {SM_CLOCK_HZ / 1e6:.0f} MHz: "
          f"{SMS * ISSUE_LANES * SM_CLOCK_HZ / 1e12:.2f} T instructions/s, "
          f"{SMS * MUFU_LANES * SM_CLOCK_HZ / 1e12:.3f} T MUFU ops/s")
    print(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
          f"tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        fail("TF32 is on; the port must run IEEE fp32")
    return card


def phase_build():
    from repro_torch.kernels import _build
    _build.load()
    info = _build.BUILD_INFO
    print(f"[build] {'built' if info['built'] else 'loaded'} "
          f"{info['directory']} in {info['seconds']:.1f} s")
    log = (Path(info["directory"]) / "ptxas.log").read_text()
    (OUT_DIR / "ptxas.log").write_text(log)
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
    spills = sum(int(s) for s in re.findall(r"(\d+) bytes spill stores", log))
    if not regs:
        fail("ptxas reported no kernels")
    print(f"[build] {len(regs)} kernels, {min(regs)}-{max(regs)} registers "
          f"per thread, {spills} bytes of spill stores in all "
          f"(chiprun_out/ptxas.log)")
    for line in dense_build_lines(log):
        print(f"[build] {line}")
    for line in attention_build_lines(log):
        print(f"[build] {line}")
    for line in norm_build_lines(log):
        print(f"[build] {line}")
    return info


def ptxas_registers(log, kernel):
    """{template arguments of ``kernel``'s mangled name: (registers, spill
    store bytes)} for each instantiation of ``kernel`` in a ptxas log."""
    out, entry, spill = {}, None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            hit = re.search(kernel + r"I(.*)EEv", m.group(1))
            entry, spill = (hit.group(1) if hit else None), 0
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and entry is not None:
            out[entry] = (int(m.group(1)), spill)
            entry = None
    return out


def template_args(args):
    """The integer template arguments of a mangled instantiation."""
    return [int(v.replace("n", "-"))
            for v in re.findall(r"L[ib](n?\d+)E", args + "E")]


def norm_build_lines(log):
    """ptxas' registers and spill stores of every instantiation of the
    norm kernel <norm, rep, act, groups> and of the fused unit's norm pass
    <norm, rep, groups>, a line for each groups."""
    out = []
    for kernel in ("pfp_norm_kernel", "pfp_norm_srm_kernel"):
        by_groups = {}
        for args, (regs, spill) in ptxas_registers(log, kernel).items():
            *lead, groups = template_args(args)
            by_groups.setdefault(groups, []).append(
                f"<{', '.join(map(str, lead))}> {regs}/{spill}")
        for groups, cells in sorted(by_groups.items()):
            out.append(f"{kernel} G {groups} (<norm, rep[, act]> registers/"
                       f"spill bytes): " + ", ".join(sorted(cells)))
    return out


def dense_build_lines(log):
    """ptxas' registers and spill stores of each wide-tile instantiation
    of the dense kernel (tn 8), and nvcc's seconds for its source."""
    out = []
    dense = ptxas_registers(log, "pfp_dense_ring_kernel")
    for args, (regs, spill) in dense.items():
        mode, bn, tn, tm, st, batched = re.findall(r"L[ib](\d+)E", args + "E")
        if tn == "8":
            form = " batched" if batched == "1" else ""
            out.append(f"dense wide tile mode {mode} (bn {bn}, tn {tn}, "
                       f"tm {tm}, stages {st}){form}: {regs} registers, "
                       f"{spill} bytes spilled")
    found = re.search(r"== pfp_dense\.cu \(([\d.]+) s\)", log)
    if found:
        out.append(f"pfp_dense.cu: {len(dense)} instantiations, nvcc "
                   f"{found.group(1)} s")
    return out


def attention_build_lines(log):
    """ptxas' registers of each attention kernel instantiation, and each
    cache-kernel block's occupancy as the library computes it (registers
    included) beside attention_plan's model of it (kv_block_bytes,
    KV_REGISTERS, blocks_per_sm); fails where they differ, since the plan
    would then count on a wave the card does not run."""
    import ctypes
    from repro_torch.kernels import _build
    from repro_torch.kernels.pfp_attention import (BLOCK_ROWS, HEAD_DIMS,
                                                   KV_REGISTERS,
                                                   blocks_per_sm,
                                                   kv_block_bytes)
    out = []
    for kernel in ("pfp_attention_kernel", "pfp_attention_kv_kernel"):
        found = []
        for args, (r, sp) in sorted(ptxas_registers(log, kernel).items()):
            tmpl = ", ".join(re.findall(r"L[ib](\d+)E", args + "E"))
            found.append(f"<{tmpl}> {r} registers, {sp} bytes spilled")
        out.append(f"{kernel}: " + ", ".join(found))
    lib = _build.load()
    for d in HEAD_DIMS:
        for bq in BLOCK_ROWS:
            for paged in (0, 1):
                nbytes, per_sm = ctypes.c_int(), ctypes.c_int()
                _build.check(lib.pfp_attention_kv_block(
                    paged, d, bq, ctypes.byref(nbytes),
                    ctypes.byref(per_sm)), "pfp_attention_kv_block")
                model = (kv_block_bytes(d, bq), blocks_per_sm(d, bq))
                if (nbytes.value, per_sm.value) != model:
                    fail(f"cache kernel D {d}, {bq} rows, paged {paged}: "
                         f"the library gives {nbytes.value} B and "
                         f"{per_sm.value} blocks an SM, the plan's model "
                         f"{model}")
            out.append(f"cache kernel D {d}, {bq} rows: {model[0]} B of "
                       f"shared memory, {KV_REGISTERS[(d, bq)]} registers "
                       f"(KV_REGISTERS): {model[1]} blocks an SM, as the "
                       f"library's occupancy gives (both forms)")
    return out


def _max_err(got, want):
    return max(float((g - w).abs().max()) for g, w in zip(got, want))


def _check_close(name, got, want, tol):
    import torch
    for g, w in zip(got, want):
        if g.shape != w.shape or not torch.isfinite(g).all():
            fail(f"{name}: shape {tuple(g.shape)} vs {tuple(w.shape)} or "
                 f"non-finite output")
        if not torch.allclose(g, w, **tol):
            fail(f"{name}: max abs err {float((g - w).abs().max()):.3e} "
                 f"outside {tol}")


def phase_kernels(device):
    """Each kernel against its plain version; returns max abs err per kernel."""
    import torch
    from repro_torch.kernels import ops, ref
    errs = {k: 0.0 for k in KERNELS}
    cases = sorted(set(sum((main_path_calls(b, f) for b in BATCHES
                            for f in ("srm", "var")), [])))
    cases += [("dense", (33, 100, 53)), ("dense_first_layer", (7, 25, 6)),
              ("dense_var", (33, 100, 53)), ("activation", (3, 37, 70)),
              ("maxpool2d", (2, 6, 10, 5)), ("dense", (1, 784, 100)),
              ("dense_var", (1, 1, 1))]
    # Ragged K on both sides of the split's boundaries, and granite-8b's
    # decode shapes, in all three modes.
    for kernel in ("dense", "dense_first_layer", "dense_var"):
        cases += [(kernel, (37, k, 100)) for k in SPLIT_CHECK_K]
        cases += [(kernel, (DECODE_SLOTS, 4096, n))
                  for n in (4096, 1024, 14336, 49152)]
    for i, (kernel, shape) in enumerate(cases):
        args = operands(kernel, shape, 100 + i, device)
        got = run_kernel(kernel, args)
        torch.cuda.synchronize()
        want = run_plain(kernel, args)
        tol = DENSE_TOL if kernel.startswith("dense") else ELEMENTWISE_TOL
        _check_close(f"{kernel}{shape}", got, want, tol)
        err = _max_err(got, want)
        errs[kernel] = max(errs[kernel], err)
        plan = dense_plan_of(kernel, shape)
        print(f"[kernels] {kernel:18s} {str(shape):20s} max_abs_err {err:.3e}"
              + ("" if plan is None else f"  plan {plan}"))
        del args, got, want
    act_pool_checks(device, errs)
    cancellation_check(device)
    m_independence_check(device)
    lm_kernel_checks(device, errs)
    audio_kernel_checks(device, errs)
    cache_kernel_checks(device, errs)
    bit_contract_check(device, CACHE_DECODE)
    bit_contract_check(device, CACHE_DECODE_AUDIO)
    norm_kernel_checks(device, errs)
    norm_m_independence_check(device)
    layernorm_offset_check(device)
    moe_kernel_checks(device, errs)
    return errs


ACT_KINDS = ("relu", "gelu", "silu", "tanh", "sigmoid")


def stress_inputs(device, gauss_hermite, reps=1000):
    """(mu, var) of the activation's hard cases, each repeated ``reps``
    times: var 0 and 1e-13 (point masses), |mu| / sd 0, 5 and 40, var 1e4,
    var just over the floor, and for the Gauss-Hermite kinds mu +-90
    (exp(90) overflows fp32)."""
    import torch
    cases = [(0.0, 0.0), (-1.5, 0.0), (2.0, 1e-13), (-2.0, 1e-13),
             (0.0, 1.0), (5.0, 1.0), (-5.0, 1.0), (40.0, 1.0), (-40.0, 1.0),
             (3.0, 1e4), (-300.0, 1e4), (0.5, 2e-12)]
    if gauss_hermite:
        cases += [(90.0, 1.0), (-90.0, 1.0), (90.0, 0.0), (-90.0, 1e-13)]
    mu = torch.tensor([m for m, _ in cases] * reps, device=device)
    var = torch.tensor([v for _, v in cases] * reps, device=device)
    return mu, var


def _offset_copy(t, k):
    """``t`` copied into a buffer ``k`` floats past its start: a view that
    is 16-byte aligned only at k 0."""
    import torch
    buf = torch.empty(t.numel() + 4, device=t.device)
    view = buf[k:k + t.numel()].view(t.shape)
    view.copy_(t)
    return view


def _pool64(mu, var):
    """ref.pfp_maxpool2d_ref's Clark tournament in fp64: W pairs, then H."""
    import torch
    from repro_torch.core import pfp_math
    m, v = mu.double(), var.double()
    for pair in (lambda t: (t[:, :, 0::2], t[:, :, 1::2]),
                 lambda t: (t[:, 0::2], t[:, 1::2])):
        (ma, mb), (va, vb) = pair(m), pair(v)
        m, srm = pfp_math.clark_max_moments(ma, va, mb, vb)
        v = torch.clamp(srm - m * m, min=0.0)
    return m, v


def act_pool_checks(device, errs):
    """Rows 3 and 4 beyond the main-path shapes: the five activation kinds
    on random and on stress inputs, operands offset by 1-3 floats (no
    float4), the pool on VAR and SRM input (SRM bit for bit to_var() and
    the VAR kernel), the same bits under other launch plans, and each
    kernel's error against fp64 beside its plain version's (the kernel no
    worse than 4x the plain version, as the dense kernel's cancellation
    check asks; the pool's stress windows are held to that alone).
    Updates ``errs``."""
    import torch
    from repro_torch.core.gaussian import SRM, GaussianTensor
    from repro_torch.core.dispatch import pfp_maxpool2d as pool_op
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.ref import ACTIVATION_REFS
    from repro_torch.kernels.pfp_activations import (ElementwisePlan,
                                                     pfp_activation_cuda)
    from repro_torch.kernels.pfp_maxpool import pfp_maxpool2d_cuda

    def held(name, kernel, got, want, tol=ELEMENTWISE_TOL):
        torch.cuda.synchronize()
        _check_close(name, got, want, tol)
        errs[kernel] = max(errs[kernel], _max_err(got, want))
        return _max_err(got, want)

    def fp64_errs(name, got, plain, exact):
        err_k = _max_err([g.double() for g in got], exact)
        err_p = _max_err([p.double() for p in plain], exact)
        print(f"[kernels] {name} vs fp64: kernel max_abs_err {err_k:.3e}, "
              f"fp32 plain {err_p:.3e}")
        if err_k > 4 * max(err_p, 1e-9):
            fail(f"{name}: kernel err {err_k:.3e} against fp64 > 4 x the "
                 f"plain version's {err_p:.3e}")

    mu, var = gaussian((100, 14, 14, 16), 7, device)
    var[0] = 0.0
    for kind in ACT_KINDS:
        got = ops.pfp_activation(mu, var, kind=kind)
        want = ref.pfp_activation_ref(mu, var, kind)
        err = held(f"activation[{kind}]", "activation", got, want)
        fp64_errs(f"activation[{kind:7s}] (100, 14, 14, 16)", got, want,
                  ACTIVATION_REFS[kind](mu.double(), var.double()))
        smu, svar = stress_inputs(device, kind != "relu")
        sgot = ops.pfp_activation(smu, svar, kind=kind)
        swant = ref.pfp_activation_ref(smu, svar, kind)
        serr = held(f"activation[{kind}] stress", "activation", sgot, swant)
        fp64_errs(f"activation[{kind:7s}] stress", sgot, swant,
                  ACTIVATION_REFS[kind](smu.double(), svar.double()))
        # Misaligned: every pointer 1-3 floats off 16 bytes.
        off = 0.0
        for k in (1, 2, 3):
            a, b = _offset_copy(mu, k), _offset_copy(var, k)
            off = max(off, held(f"activation[{kind}] offset {k}",
                                "activation", ops.pfp_activation(a, b,
                                                                 kind=kind),
                                want))
        # The same bits under other plans: groups of 4 over 3 blocks, one
        # element a thread in blocks of 64, 7 blocks that stride.
        n = mu.numel()
        first = pfp_activation_cuda(mu, var, kind=kind)
        for plan in (ElementwisePlan(4, 256, 3), ElementwisePlan(1, 64,
                                                                 -(-n // 64)),
                     ElementwisePlan(1, 256, 7)):
            other = pfp_activation_cuda(mu, var, kind=kind, plan=plan)
            if not all(torch.equal(a, b) for a, b in zip(first, other)):
                fail(f"activation[{kind}]: plan {tuple(plan)} changes bits")
        print(f"[kernels] activation[{kind:7s}] max_abs_err {err:.3e}, "
              f"stress {serr:.3e}, offset 1-3 floats {off:.3e}; bits equal "
              f"under 4 plans")
    for batch in BATCHES:
        for shape in ((batch, 28, 28, 6), (batch, 14, 14, 16)):
            mu, var = gaussian(shape, batch + shape[3], device)
            var[0, :2] = 0.0                     # deterministic windows
            srm = var + mu * mu
            want = ref.pfp_maxpool2d_ref(mu, var)
            got = ops.pfp_maxpool2d(mu, var)
            err = held(f"maxpool2d var {shape}", "maxpool2d", got, want)
            x = GaussianTensor(mu, srm, SRM)
            got_srm = ops.pfp_maxpool2d(mu, srm, rep="srm")
            via = ops.pfp_maxpool2d(mu, x.to_var().second)
            if not all(torch.equal(a, b) for a, b in zip(got_srm, via)):
                fail(f"maxpool2d {shape}: SRM input is not bit for bit "
                     f"to_var() and the VAR kernel")
            op = pool_op(x, impl="kernel")
            if not (torch.equal(op.mean, via[0]) and
                    torch.equal(op.second, via[1])):
                fail(f"maxpool2d {shape}: the kernel impl on SRM input is "
                     f"not bit for bit to_var() and the VAR kernel")
            off = 0.0
            for k in (1, 2, 3):
                a, b = _offset_copy(mu, k), _offset_copy(srm, k)
                off = max(off, held(
                    f"maxpool2d srm {shape} offset {k}", "maxpool2d",
                    ops.pfp_maxpool2d(a, b, rep="srm"),
                    ref.pfp_maxpool2d_ref(a, b - a * a)))
            units = mu.numel() // 4
            for plan in (ElementwisePlan(1, 64, -(-units // 64)),
                         ElementwisePlan(2, 256, 5)):
                other = pfp_maxpool2d_cuda(mu, srm, rep="srm", plan=plan)
                if not all(torch.equal(a, b) for a, b in zip(got_srm,
                                                              other)):
                    fail(f"maxpool2d {shape}: plan {tuple(plan)} changes "
                         f"bits")
            if batch == MAIN_BATCH:
                fp64_errs(f"maxpool2d {shape}", got, want, _pool64(mu, var))
            print(f"[kernels] maxpool2d {str(shape):18s} var max_abs_err "
                  f"{err:.3e}, offset 1-3 floats {off:.3e}; SRM input bit "
                  f"for bit to_var() + the VAR kernel; bits equal under 3 "
                  f"plans")
    # Windows of the stress cases: where a Clark max's variance is a small
    # difference of two large moments (|mu| / sd 40) every fp32 version
    # loses digits, so the kernel is held against fp64 there.
    smu, svar = stress_inputs(device, False, reps=600)   # 7200 = 75 x 96
    smu, svar = smu.view(75, 4, 4, 6), svar.view(75, 4, 4, 6)
    sgot = ops.pfp_maxpool2d(smu, svar)
    torch.cuda.synchronize()
    if not all(torch.isfinite(t).all() for t in sgot) or sgot[1].min() < 0:
        fail("maxpool2d stress: non-finite or negative variance")
    fp64_errs("maxpool2d stress (75, 4, 4, 6)", sgot,
              ref.pfp_maxpool2d_ref(smu, svar), _pool64(smu, svar))


def moe_kernel_checks(device, errs):
    """The batched expert kernel in its three modes against its plain
    version at the MoE shapes and a ragged one, and bit for bit against the
    single dense kernel on every expert's slice; updates ``errs``."""
    import torch
    from repro_torch.kernels.pfp_dense import (MODE_FIRST_LAYER, MODE_SRM,
                                               MODE_VAR, pfp_dense_cuda)
    modes = dict(zip(BATCHED_KERNELS, (MODE_SRM, MODE_FIRST_LAYER, MODE_VAR)))
    for seed, shape in enumerate(MOE_SHAPES + ((3, 7, 130, 5),), start=900):
        for kernel in BATCHED_KERNELS:
            args = operands(kernel, shape, seed, device)
            got = run_kernel(kernel, args)
            torch.cuda.synchronize()
            want = run_plain(kernel, args)
            _check_close(f"{kernel}{shape}", got, want, DENSE_TOL)
            err = _max_err(got, want)
            errs[kernel] = max(errs[kernel], err)
            del want
            for e in range(shape[0]):
                one = pfp_dense_cuda(*(a[e] for a in args),
                                     mode=modes[kernel])
                if not (torch.equal(one[0], got[0][e])
                        and torch.equal(one[1], got[1][e])):
                    fail(f"{kernel}{shape}: expert {e} differs from the "
                         f"single dense kernel on its slice")
            print(f"[kernels] {kernel:25s} {str(shape):20s} max_abs_err "
                  f"{err:.3e}, every expert bitwise the dense kernel's")
            if shape in (MOE_DECODE_UP, (3, 7, 130, 5)):
                batched_rows_check(kernel, shape, args, seed, device)
            del args, got


def batched_rows_check(kernel, shape, args, seed, device):
    """The batched kernel with kept-row counts: x zeroed past each count
    (as the MoE dispatch leaves it), the rows past it written as +0, the
    rest bit for bit the rows=None kernel's on the same x, and within
    DENSE_TOL of the plain version with the same counts."""
    import torch
    e, c = shape[:2]
    g = torch.Generator().manual_seed(seed)
    rows = torch.randint(0, c + 1, (e,), generator=g, dtype=torch.int32)
    rows[0], rows[-1] = 0, c
    rows = rows.to(device)
    keep = torch.arange(c, device=device)[None, :, None] < rows[:, None, None]
    args = tuple(torch.where(keep, a, 0.0) if i < 2 else a
                 for i, a in enumerate(args))
    full = run_kernel(kernel, args)
    got = run_kernel(kernel, args, rows)
    torch.cuda.synchronize()
    for g_, f in zip(got, full):
        kept = keep.expand_as(g_)
        if not torch.equal(g_[kept], f[kept]):
            fail(f"{kernel}{shape} rows: kept rows differ from rows=None")
        if g_[~kept].any() or g_[~kept].signbit().any():
            fail(f"{kernel}{shape} rows: rows past a count are not +0")
    _check_close(f"{kernel}{shape} rows", got,
                 run_plain(kernel, args, rows), DENSE_TOL)
    held = int((rows > 0).sum())
    print(f"[kernels] {kernel:25s} {str(shape):20s} rows= ({held} of {e} "
          f"experts hold rows): skipped rows +0, kept rows bitwise the "
          f"rows=None kernel's")


def lm_kernel_checks(device, errs):
    """The norm, GLU and attention kernels against their plain versions at
    the LM's shapes and ragged ones; updates ``errs``."""
    import torch
    from repro_torch.kernels import ops, ref
    cfg = lm_config()
    m, d, f = LM_BATCH * LM_SEQ, cfg.d_model, cfg.d_ff

    def check(name, label, got, want, tol):
        torch.cuda.synchronize()
        _check_close(f"{name}{label}", got, want, tol)
        err = _max_err(got, want)
        errs[name] = max(errs[name], err)
        print(f"[kernels] {name:18s} {label:44s} max_abs_err {err:.3e}")

    seed = 500
    for norm, kernel, plain in (
            ("rmsnorm", ops.pfp_rmsnorm, ref.pfp_rmsnorm_ref),
            ("layernorm", ops.pfp_layernorm, ref.pfp_layernorm_ref)):
        for shape in ((m, d), (33, 100)):
            for rep in ("var", "srm"):
                for act in (None, "silu"):
                    seed += 1
                    mu, var, *vecs = operands(norm, shape, seed, device)
                    second = var if rep == "var" else var + mu * mu
                    kw = dict(rep=rep, act=act)
                    check(norm, f"{shape} rep={rep} act={act}",
                          kernel(mu, second, *vecs, **kw),
                          plain(mu, second, *vecs, **kw), NORM_TOL)
    for shape in ((m, f), (7, 333)):
        seed += 1
        args = operands("glu_product", shape, seed, device)
        check("glu_product", str(shape), ops.pfp_glu_product(*args),
              ref.pfp_glu_ref(*args), ELEMENTWISE_TOL)
    odd = [a.reshape(-1)[1:] for a in args]   # 4 bytes off 16-byte alignment
    check("glu_product", f"({odd[0].numel()},) unaligned",
          ops.pfp_glu_product(*odd), ref.pfp_glu_ref(*odd), ELEMENTWISE_TOL)
    h, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    # Row 9 at the LM's shape and at ragged ones: Tq and Tk on no multiple
    # of the block's 64 rows or the tile's 32 keys, G 4 and G 1, both
    # head_dims, causal and not.
    for shape in ((LM_BATCH, h, hkv, LM_SEQ, LM_SEQ, dh, True),
                  (LM_BATCH, h, hkv, LM_SEQ, LM_SEQ, dh, False),
                  (2, 4, 2, 37, 37, dh, True),      # ragged
                  (2, 4, 2, 5, 37, dh, True),       # Tq < Tk
                  (2, 4, 2, 45, 203, dh, False),    # Tq < Tk, not causal
                  (2, 4, 4, 130, 161, dh, True),    # G 1, Tq < Tk
                  (2, 4, 4, 77, 77, dh, False),     # G 1, not causal
                  (2, 4, 2, 37, 37, 16, True),      # reduced head_dim
                  (2, 4, 4, 45, 203, 16, False),    # head_dim 16, G 1
                  (2, 4, 2, 37, 16, dh, True)):     # rows without a key
        seed += 1
        args = operands("attention", shape, seed, device)
        got = run_kernel("attention", args)
        check("attention", str(shape), got, run_plain("attention", args),
              NORM_TOL)
        b, _, _, tq, tk, _, causal = shape
        if causal and tq > tk and float(got[0][:, :, :tq - tk].abs().max()
                                        + got[1][:, :, :tq - tk].abs().max()):
            fail(f"attention{shape}: rows without a valid key are not 0")
        again = run_kernel("attention", args)
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            fail(f"attention{shape}: two calls gave different bits")
    print("[kernels] attention          two calls give the same bits at "
          "every shape above")


def audio_kernel_checks(device, errs):
    """The kernels of musicgen-medium's path against their plain versions
    at its shapes: LayerNorm (both reps), the gelu activation and the dense
    kernel at the forward's and a 4-slot decode step's shapes, and row 9 at
    head_dim 64: the forward's (4, 24 heads of 64, 512 frames, causal,
    G 1) and ragged shapes (G 1 and 4, Tq < Tk, not causal, rows without a
    key), each twice with the same bits; updates ``errs``. The cache
    kernels at head_dim 64 are CACHE_CHECKS' audio entries."""
    import torch
    from repro_torch.kernels import ops, ref
    cfg = audio_config()
    seed = 600
    for kernel, shape in dict.fromkeys(
            audio_path_calls(cfg) + audio_path_calls(cfg, decode=True)):
        seed += 1
        reps = ("var", "srm") if kernel == "layernorm" else (None,)
        for rep in reps:
            args = operands(kernel, shape, seed, device)
            if rep == "srm":
                args = (args[0], args[1] + args[0] * args[0], *args[2:])
            kw = {} if rep is None else {"rep": rep}
            if kernel == "layernorm":
                got = ops.pfp_layernorm(*args, **kw)
                want = ref.pfp_layernorm_ref(*args, **kw)
            else:
                got = run_kernel(kernel, args)
                want = run_plain(kernel, args)
            torch.cuda.synchronize()
            tol = (DENSE_TOL if kernel == "dense" else NORM_TOL
                   if kernel in ("layernorm", "attention")
                   else ELEMENTWISE_TOL)
            label = f"{shape}" + ("" if rep is None else f" rep={rep}")
            _check_close(f"{kernel}{label}", got, want, tol)
            err = _max_err(got, want)
            errs[kernel] = max(errs[kernel], err)
            print(f"[kernels] {kernel:18s} {label:44s} max_abs_err {err:.3e}"
                  " (musicgen-medium)")
            if kernel == "attention":
                again = run_kernel(kernel, args)
                if not all(torch.equal(x, y) for x, y in zip(got, again)):
                    fail(f"attention{shape}: two calls gave different bits")
            del args, got, want
    for shape in ((2, 4, 4, 37, 37, 64, True),      # G 1, ragged
                  (2, 4, 4, 45, 203, 64, False),    # Tq < Tk, not causal
                  (2, 8, 2, 130, 161, 64, True),    # G 4, Tq < Tk
                  (2, 4, 4, 37, 16, 64, True)):     # rows without a key
        seed += 1
        args = operands("attention", shape, seed, device)
        got = run_kernel("attention", args)
        torch.cuda.synchronize()
        want = run_plain("attention", args)
        _check_close(f"attention{shape}", got, want, NORM_TOL)
        err = _max_err(got, want)
        errs["attention"] = max(errs["attention"], err)
        tq, tk = shape[3], shape[4]
        if tq > tk and float(got[0][:, :, :tq - tk].abs().max()
                             + got[1][:, :, :tq - tk].abs().max()):
            fail(f"attention{shape}: rows without a valid key are not 0")
        again = run_kernel("attention", args)
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            fail(f"attention{shape}: two calls gave different bits")
        print(f"[kernels] attention          {str(shape):44s} max_abs_err "
              f"{err:.3e}, twice the same bits")


def cache_kernel_checks(device, errs):
    """The KV-cache kernel against its plain version at each shape of
    CACHE_CHECKS, and the paged kernel at page sizes 1, 16 and 24 (shuffled
    pages, trash-page padding) against its plain version and, bit for bit,
    against the cache kernel on the same keys; updates ``errs``."""
    import torch
    for seed, (label, shape) in enumerate(CACHE_CHECKS.items(), start=700):
        args = operands("attention_cache", shape, seed, device)
        got = run_kernel("attention_cache", args)
        torch.cuda.synchronize()
        want = run_plain("attention_cache", args)
        _check_close(f"attention_cache[{label}]", got, want, NORM_TOL)
        err = _max_err(got, want)
        errs["attention_cache"] = max(errs["attention_cache"], err)
        dead = args[5] == 0
        if dead.any() and float(got[0][dead].abs().max()
                                + got[1][dead].abs().max()):
            fail(f"attention_cache[{label}]: a slot without keys is not 0")
        print(f"[kernels] attention_cache    {label:44s} max_abs_err "
              f"{err:.3e}")
        for ps in CHECK_PAGE_SIZES:
            pools, table = paged_from_cache(args[1:4], shape[7], ps, seed,
                                            device)
            pargs = (args[0], *pools, table, *args[4:])
            paged = run_kernel("attention_paged", pargs)
            torch.cuda.synchronize()
            want = run_plain("attention_paged", pargs)
            _check_close(f"attention_paged[{label}, ps {ps}]", paged, want,
                         NORM_TOL)
            perr = _max_err(paged, want)
            errs["attention_paged"] = max(errs["attention_paged"], perr)
            same = all(torch.equal(a, c) for a, c in zip(paged, got))
            if not same:
                fail(f"attention_paged[{label}, ps {ps}] differs from the "
                     f"cache kernel on the same keys")
            print(f"[kernels] attention_paged    {label + f', ps {ps}':44s} "
                  f"max_abs_err {perr:.3e}, bitwise the cache kernel's")


def bit_contract_check(device, shape):
    """The cache kernels' rows depend on their own query and keys only
    (csrc/pfp_attention.cu: segments of fixed keys, one left fold). One
    slot at the widths of the decode ``shape`` (granite-8b's 32 / 8 heads of
    128, musicgen-medium's 24 / 24 of 64; 1024 keys): its rows
    at positions 300-811 from one Tq 512 call against the same rows in
    chunks of 128 rows and at Tq 1 (positions 300, 427, 428, 811) as slot
    0 of a 4-slot batch, under every cluster size of the decode block
    (plan=) and through shuffled pages of 16 rows; all torch.equal."""
    import torch
    from repro_torch.kernels.pfp_attention import (MAX_CLUSTER,
                                                   pfp_attention_cache_cuda,
                                                   pfp_attention_paged_cuda)
    _, h, hkv, _, s, d = shape[:6]
    n0, n = 300, 512
    g = torch.Generator().manual_seed(800)
    q_all = torch.randn((h, n0 + n, d), generator=g).to(device)
    caches = [torch.randn((4, hkv, s, d), generator=g).to(device)
              for _ in range(3)]
    caches[2] = caches[2].abs()

    def run(q_start, tq, b=1, ps=None, plan=None):
        q = torch.randn((b, h, tq, d), generator=g).to(device)
        q[0] = q_all[:, q_start:q_start + tq]
        lens = [q_start + tq] + [500] * (b - 1)
        ints = [torch.tensor(v, dtype=torch.int32, device=device)
                for v in ([q_start] + [100] * (b - 1), lens)]
        kv = [c[:b] for c in caches]
        if ps is None:
            mu, var = pfp_attention_cache_cuda(q, *kv, *ints, scale=d ** -0.5,
                                               plan=plan)
        else:
            pools, table = paged_from_cache(kv, lens, ps, 801, device)
            mu, var = pfp_attention_paged_cuda(q, *pools, table, *ints,
                                               scale=d ** -0.5, plan=plan)
        return mu[0], var[0]

    whole = run(n0, n)
    runs = [(n0 + 128 * c, 128, 1, None, None) for c in range(n // 128)]
    for pos in (n0, n0 + 127, n0 + 128, n0 + n - 1):
        runs += [(pos, 1, 4, None, (8, c)) for c in range(1, MAX_CLUSTER + 1)]
        runs.append((pos, 1, 4, PAGE_SIZE, None))
    for q_start, tq, b, ps, plan in runs:
        got = run(q_start, tq, b, ps, plan)
        rows = slice(q_start - n0, q_start - n0 + tq)
        if not all(torch.equal(x, w[:, rows]) for x, w in zip(got, whole)):
            fail(f"bit contract: rows {q_start}..{q_start + tq - 1} (Tq "
                 f"{tq}, B {b}, pages {ps}, plan {plan}) differ from the "
                 f"Tq {n} call's")
    torch.cuda.synchronize()
    print(f"[kernels] bit contract ({h} / {hkv} heads of {d}): "
          f"{len(runs) + 1} calls, every row of the slot bit for bit (Tq "
          f"512 / 128 / 1, B 1 / 4, clusters 1-{MAX_CLUSTER}, pages of "
          f"{PAGE_SIZE})")


def layernorm_offset_check(device):
    """LayerNorm rows offset by 100, against fp64: the kernel sums the
    centred spread, no further from fp64 than FP64_FACTOR times the fp32
    plain version; the TPU kernel's moment form sum(var + mu^2)/d -
    mu_tok^2 cancels there (its fp32 error is printed beside)."""
    import torch
    from repro_torch.kernels import ops, ref
    mu, var = gaussian((4, 4096), 77, device)
    mu = mu + 100.0
    gain = torch.ones(4096, device=device)
    got = ops.pfp_layernorm(mu, var, gain)
    m64, v64 = mu.double(), var.double()
    tok = m64.mean(-1, keepdim=True)
    scale = torch.rsqrt((v64 + (m64 - tok) ** 2).mean(-1, keepdim=True) + 1e-6)
    want = ((m64 - tok) * scale, v64 * scale ** 2)
    torch.cuda.synchronize()
    _check_close("layernorm offset 100", [g.double() for g in got], want,
                 NORM_TOL)
    err = _max_err([g.double() for g in got], want)
    plain_err = _max_err([g.double() for g in ref.pfp_layernorm_ref(
        mu, var, gain)], want)
    if err > FP64_FACTOR * plain_err:
        fail(f"layernorm offset 100: the kernel {err:.3e} from fp64, more "
             f"than {FP64_FACTOR}x the fp32 plain version's {plain_err:.3e}")
    tok32 = mu.mean(-1, keepdim=True)
    moment = torch.mean(var + mu * mu, -1, keepdim=True) - tok32 * tok32
    moment_err = float(((mu - tok32) * torch.rsqrt(moment + 1e-6)
                        - want[0]).abs().max())
    print(f"[kernels] layernorm offset 100 vs fp64: kernel max_abs_err "
          f"{err:.3e}, the fp32 centred plain version {plain_err:.3e} "
          f"(at most {FP64_FACTOR}x); the moment form in fp32 "
          f"{moment_err:.3e}")


def norm_kernel_checks(device, errs):
    """Rows 6 and 7 at the 4-slot decode shapes (musicgen-medium's 1536,
    deepseek-moe-16b's 2048, granite-8b's 4096) and at ragged widths (333:
    no float4 groups; 4097: one past two groups a thread), VAR and SRM
    input, without and with an activation (RMSNorm silu, LayerNorm gelu),
    against their plain versions at NORM_TOL; each also on operands 4
    bytes off 16-byte alignment (scalar loads), which must give the
    aligned call's bits. Updates ``errs``."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.pfp_norms import norm_plan
    seed = 700
    for norm, kernel, plain, act in (
            ("rmsnorm", ops.pfp_rmsnorm, ref.pfp_rmsnorm_ref, "silu"),
            ("layernorm", ops.pfp_layernorm, ref.pfp_layernorm_ref, "gelu")):
        for shape in NORM_DECODE + NORM_RAGGED:
            worst = 0.0
            for rep in ("var", "srm"):
                for a in (None, act):
                    seed += 1
                    mu, var, *vecs = operands(norm, shape, seed, device)
                    second = var if rep == "var" else var + mu * mu
                    kw = dict(rep=rep, act=a)
                    got = kernel(mu, second, *vecs, **kw)
                    odd = kernel(*(_offset_copy(t, 1)
                                   for t in (mu, second, *vecs)), **kw)
                    want = plain(mu, second, *vecs, **kw)
                    torch.cuda.synchronize()
                    label = f"{norm}{shape} rep={rep} act={a}"
                    _check_close(label, got, want, NORM_TOL)
                    if not all(torch.equal(x, y) for x, y in zip(got, odd)):
                        fail(f"{label}: unaligned operands changed the bits")
                    worst = max(worst, _max_err(got, want))
            errs[norm] = max(errs[norm], worst)
            print(f"[kernels] {norm:18s} {str(shape):12s} plan "
                  f"{tuple(norm_plan(shape[1]))}: var/srm, act None/{act}: "
                  f"max_abs_err {worst:.3e}; unaligned operands the same "
                  f"bits")


def norm_m_independence_check(device):
    """A norm row's bits depend on d only (csrc/pfp_norm.cuh): rows 0-3
    of the same operands bit for bit at M = 4, 33 and 2048, row 0 at M 1,
    and rows 0-3 at M 33 with operands off 16-byte alignment, for both
    norms and reps at 1536, 2048, 4096 and 333."""
    import torch
    from repro_torch.kernels import ops
    for norm, kernel in (("rmsnorm", ops.pfp_rmsnorm),
                         ("layernorm", ops.pfp_layernorm)):
        for d in (1536, 2048, 4096, 333):
            mu, var, *vecs = operands(norm, (2048, d), 41 + d, device)
            for rep in ("var", "srm"):
                second = var if rep == "var" else var + mu * mu
                first = kernel(mu[:4], second[:4], *vecs, rep=rep)
                runs = [(m, kernel(mu[:m], second[:m], *vecs, rep=rep))
                        for m in (1, 33, 2048)]
                runs.append(("33 unaligned", kernel(
                    _offset_copy(mu[:33], 1), _offset_copy(second[:33], 1),
                    *vecs, rep=rep)))
                for m, out in runs:
                    rows = 1 if m == 1 else 4
                    if not all(torch.equal(t[:rows], f[:rows])
                               for t, f in zip(out, first)):
                        fail(f"{norm} (M, {d}) rep={rep}: rows 0-{rows - 1} "
                             f"at M {m} differ from M 4")
            print(f"[kernels] {norm:18s} (M, {d}): rows 0-3 bit for bit at "
                  f"M 1 / 4 / 33 / 2048 and unaligned at M 33, both reps")


def m_independence_check(device):
    """A row's bits depend only on (K, N, mode): the first 6 rows of the
    same operands, bit for bit, at M = 6, 100, 128, 256 and 1024 (up to
    four plans), at a split shape and at decode and large-regime shapes (at
    (14336, 4096): the decode tile, the (64, 4) ring tile at TM 4, 64 x 128
    and 128 x 128), in each mode."""
    import torch
    for kernel in ("dense", "dense_first_layer", "dense_var"):
        for k, n in ((784, 120), (4096, 1024), (2048, 1408), (14336, 4096)):
            args = operands(kernel, (1024, k, n), 31, device)
            first, plans = None, []
            for m in (6, 100, 128, 256, 1024):
                part = tuple(a[:m] if i < 2 else a for i, a in enumerate(args))
                got = [t[:6] for t in run_kernel(kernel, part)]
                plans.append(dense_plan_of(kernel, (m, k, n)))
                if first is None:
                    first = got
                elif not all(torch.equal(a, b) for a, b in zip(got, first)):
                    fail(f"{kernel} (M, {k}, {n}): rows 0-5 at M {m} differ "
                         f"from M 6")
            print(f"[kernels] {kernel:18s} (M, {k}, {n}): rows 0-5 bit for "
                  f"bit at M 6 / 100 / 128 / 256 / 1024, plans {plans}")
            del args


def cancellation_check(device):
    """Eq. 12 with srm ~= mu^2: the variance is a small difference of two
    large sums. The kernel's error against an fp64 version must be no worse
    than 4x the fp32 plain version's (TF32 would be ~1000x worse)."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.pfp_dense import dense_plan
    # (M, K, N) for the dense kernel; (E, C, K, N) for the batched one.
    # The last three run the large regime, the last two its 128 x 128 tile.
    for shape in ((100, 784, 100), (10, 784, 120), (19600, 150, 16),
                  (8, 240, 2048, 128), (512, 4096, 1024), (2048, 4096, 1024),
                  (8, 240, 2048, 1408)):
        *lead, k, n = shape
        g = torch.Generator(device="cpu").manual_seed(sum(shape))
        mx = torch.relu(torch.randn((*lead, k), generator=g)) + 0.1
        mw = 0.05 * torch.randn((*lead[:-1], k, n), generator=g)
        sx = mx * mx + 1e-6 * torch.rand((*lead, k), generator=g)
        sw = mw * mw + 4e-7                       # sigma_init 1e-3, cal 0.4
        mx, mw, sx, sw = (a.to(device) for a in (mx, mw, sx, sw))
        if len(shape) == 4:
            _, var_k = ops.pfp_dense_batched(mx, sx, mw, sw)
            _, var_p = ref.pfp_dense_batched_ref(mx, sx, mw, sw)
        else:
            _, var_k = ops.pfp_dense(mx, sx, mw, sw)
            _, var_p = ref.pfp_dense_ref(mx, sx, mw, sw)
        d = [a.double() for a in (mx, sx, mw, sw)]
        var_64 = d[1] @ d[3] - (d[0] * d[0]) @ (d[2] * d[2])
        torch.cuda.synchronize()
        err_k = float((var_k.double() - var_64).abs().max())
        err_p = float((var_p.double() - var_64).abs().max())
        scale = float(var_64.abs().max())
        e, (m, k, n) = (shape[0], shape[1:]) if len(shape) == 4 else (
            1, shape)
        print(f"[kernels] eq12 cancellation {shape}: max var {scale:.3e}, "
              f"kernel err {err_k:.3e}, fp32 plain err {err_p:.3e}, plan "
              f"{tuple(dense_plan(m, n, k, e))}")
        if err_k > 4 * max(err_p, 1e-12):
            fail(f"Eq. 12 cancellation at {shape}: kernel err {err_k:.3e} "
                 f"> 4 x plain err {err_p:.3e}")


def _models(device):
    import torch
    from repro_torch.bayes.convert import svi_to_pfp
    from repro_torch.models.simple import MLP, LeNet5
    models = {}
    for name, cls in (("lenet5", LeNet5), ("mlp", MLP)):
        model = cls(sigma_init=1e-3, generator=torch.Generator().manual_seed(0),
                    device=device)
        models[name] = svi_to_pfp(model, calibration_factor=CALIBRATION)
    return models


def _requests(name, split_images):
    x = split_images
    return x[..., None] if name == "lenet5" else x.reshape(len(x), -1)


def phase_serving(device):
    """The main path: PFP forward with the kernels, Eq. 1-3, AUROC."""
    import torch
    from repro_torch.bayes import metrics
    from repro_torch.core.modes import Mode
    from repro_torch.data.dirty_mnist import dirty_mnist
    from repro_torch.kernels._launch import LAUNCHES, reset_launch_counts
    from repro_torch.nn.module import Context

    models = _models(device)
    _, evals = dirty_mnist(n_train=2, n_eval=MAIN_BATCH, seed=0)
    splits = {s: evals[s][0] for s in ("clean", "ambiguous", "ood")}
    outs = {}
    reset_launch_counts()
    t0 = time.perf_counter()
    for name, model in models.items():
        for formulation in ("srm", "var"):
            ctx = Context(mode=Mode.PFP, impl="kernel", formulation=formulation,
                          device=device)
            for split, imgs in splits.items():
                if formulation == "var" and split != "clean":
                    continue  # one Eq. 7 pass per model is enough to run it
                out = model(_requests(name, imgs), ctx)
                outs[(name, formulation, split)] = out
                if formulation == "srm":
                    gen = torch.Generator(device=device).manual_seed(1)
                    outs[(name, "metrics", split)] = \
                        metrics.pfp_predictive_metrics(gen, out.mean, out.var,
                                                       100)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: LAUNCHES[k] for k in CNN_KERNELS}
    print(f"[serving] main path: {len(outs)} results in {seconds:.3f} s "
          f"(first calls included); launches {launches}")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        fail(f"kernels never launched on the main path: {missing}")

    for name, model in models.items():
        for formulation in ("srm", "var"):
            out = outs[(name, formulation, "clean")]
            ctx = Context(mode=Mode.PFP, impl="eager", formulation=formulation,
                          device=device)
            ref_out = model(_requests(name, splits["clean"]), ctx)
            for part in ("mean", "var"):
                got, want = getattr(out, part), getattr(ref_out, part)
                rtol, atol = MODEL_TOL[part]
                if tuple(got.shape) != (MAIN_BATCH, 10) or \
                        not torch.isfinite(got).all():
                    fail(f"{name}/{formulation} {part}: bad logits")
                if not torch.allclose(got, want, rtol=rtol, atol=atol):
                    fail(f"{name}/{formulation} {part} kernel vs eager: max "
                         f"abs err {float((got - want).abs().max()):.3e}")
            if float(out.var.min()) <= 0:
                fail(f"{name}/{formulation}: non-positive logit variance")
            err_m = float((out.mean - ref_out.mean).abs().max())
            err_v = float((out.var - ref_out.var).abs().max())
            print(f"[serving] {name} {formulation}: kernel vs eager logits "
                  f"max abs err mean {err_m:.3e} var {err_v:.3e}")
        mi = {s: outs[(name, "metrics", s)]["mi"] for s in splits}
        auc = metrics.auroc(mi["ood"], mi["clean"])
        print(f"[serving] {name} (untrained random weights, sigma_init 1e-3, "
              f"cal {CALIBRATION}): mean MI " + ", ".join(
                  f"{s} {float(v.mean()):.4e}" for s, v in mi.items())
              + f"; MI-AUROC ood vs clean {auc:.4f}")
    return launches


def _lm_model(device):
    """granite-8b at full width, cut to LM_LAYERS layers: random variational
    weights drawn on the card from a seed, converted to PFP."""
    import torch
    from repro_torch.bayes.convert import svi_to_pfp
    from repro_torch.models import lm
    cfg = lm_config()
    variational = lm.init_params(
        cfg, generator=torch.Generator(device=device).manual_seed(0),
        device=device)
    model = svi_to_pfp(variational, calibration_factor=CALIBRATION)
    del variational
    return cfg, model


def _lm_requests(cfg, device):
    import torch
    return [torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_SEQ),
                          generator=torch.Generator().manual_seed(100 + i))
            .to(device) for i in range(LM_REQUESTS)]


def phase_lm(device):
    """The LM path: granite-8b PFP forwards with the kernels, next token and
    Eq. 1-3 at the last position, logits held against the eager impl."""
    import torch
    from repro_torch.bayes import metrics
    from repro_torch.core.modes import Mode
    from repro_torch.kernels._launch import LAUNCHES, reset_launch_counts
    from repro_torch.models import lm
    from repro_torch.nn.module import Context

    t0 = time.perf_counter()
    cfg, model = _lm_model(device)
    torch.cuda.synchronize()
    n_weights = cfg.param_count()
    print(f"[lm] {cfg.name}: d_model {cfg.d_model}, {cfg.num_heads}/"
          f"{cfg.num_kv_heads} heads of {cfg.head_dim}, d_ff {cfg.d_ff}, "
          f"vocab {cfg.vocab_size}, {cfg.num_layers} layers (cut from 36); "
          f"{n_weights / 1e6:.1f} M weights drawn on the card and converted "
          f"in {time.perf_counter() - t0:.2f} s")
    requests = _lm_requests(cfg, device)
    ctx = Context(mode=Mode.PFP, impl="kernel", formulation="srm",
                  device=device)
    answers, first = [], None
    reset_launch_counts()
    t0 = time.perf_counter()
    for tokens in requests:
        logits, _, _ = lm.forward(model, cfg, {"tokens": tokens}, ctx)
        last_mu, last_var = logits.mean[:, -1], logits.var[:, -1]
        gen = torch.Generator(device=device).manual_seed(1)
        unc = metrics.pfp_predictive_metrics(gen, last_mu, last_var, 100)
        answers.append((torch.argmax(last_mu, dim=-1), unc))
        if first is None:
            first = logits
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: LAUNCHES[k] for k in LM_KERNELS}
    print(f"[lm] {LM_REQUESTS} requests of {LM_BATCH} x {LM_SEQ} tokens in "
          f"{seconds:.3f} s (first calls included); launches {launches}")
    per_forward = {}
    for kernel, _ in lm_path_calls(cfg):
        per_forward[kernel] = per_forward.get(kernel, 0) + 1
    want = {k: LM_REQUESTS * per_forward[k] for k in LM_KERNELS}
    if launches != want:
        fail(f"LM launches {launches}, expected {want} "
             f"({LM_REQUESTS} forwards)")
    for i, (next_tok, unc) in enumerate(answers):
        print(f"[lm] request {i}: next tokens {next_tok.tolist()}, MI "
              + ", ".join(f"{float(v):.4e}" for v in unc["mi"])
              + ", total entropy "
              + ", ".join(f"{float(v):.4f}" for v in unc["total"]))

    ref_out, _, _ = lm.forward(
        model, cfg, {"tokens": requests[0]},
        Context(mode=Mode.PFP, impl="eager", formulation="srm", device=device))
    errs = {}
    for part in ("mean", "var"):
        got, want = getattr(first, part), getattr(ref_out, part)
        rtol, atol = MODEL_TOL[part]
        if tuple(got.shape) != (LM_BATCH, LM_SEQ, cfg.vocab_size) or \
                not torch.isfinite(got).all():
            fail(f"LM {part}: bad logits {tuple(got.shape)}")
        err = float((got - want).abs().max())
        errs[part] = (err, err / float(want.abs().max()))
        if not torch.allclose(got, want, rtol=rtol, atol=atol):
            fail(f"LM {part} kernel vs eager: max abs err {err:.3e}")
    if float(first.var.min()) <= 0:
        fail("LM: non-positive logit variance")
    print(f"[lm] kernel vs eager logits: max abs err mean {errs['mean'][0]:.3e}"
          f" ({errs['mean'][1]:.2e} of max |mean|), var {errs['var'][0]:.3e}"
          f" ({errs['var'][1]:.2e} of max var)")
    info = {"seconds": seconds, "errors": errs,
            "next_tokens": [a[0].tolist() for a in answers],
            "mi": [a[1]["mi"].tolist() for a in answers]}
    return launches, info, cfg, model


def compare_routes(label, got, want, seq):
    """The kernel impl's routing (``got``, a list of ``Routing`` per MoE
    call) against the eager impl's (``want``), before any logits are
    compared. Token t of a call lies in batch row t // ``seq``. A token
    whose expert ids differ at a top-k margin above NEAR_TIE fails the run;
    at a near tie it is printed and its row returned, to be left out of the
    logits comparison, with the rows whose keep mask changed because of it.
    Returns (set of rows, smallest top-k margin)."""
    import torch
    from repro_torch.nn.moe import top_k_margin
    if len(got) != len(want):
        fail(f"{label}: {len(got)} vs {len(want)} MoE calls")
    rows, smallest = set(), float("inf")
    for call, (a, b) in enumerate(zip(got, want)):
        k = a.expert_idx.shape[-1]
        margin = torch.minimum(top_k_margin(a.probs, k),
                               top_k_margin(b.probs, k))
        smallest = min(smallest, float(margin.min()))
        ids = (a.expert_idx != b.expert_idx).any(-1)
        for t in ids.nonzero().flatten().tolist():
            m = float(margin[t])
            if m > NEAR_TIE:
                fail(f"{label}: routing mismatch in MoE call {call} at token "
                     f"{t}: kernel {a.expert_idx[t].tolist()}, eager "
                     f"{b.expert_idx[t].tolist()}, top-{k} margin {m:.3e} "
                     f"> {NEAR_TIE}")
            print(f"[routing] {label}: MoE call {call}, token {t}: experts "
                  f"differ at a near tie (top-{k} margin {m:.3e})")
            rows.add(t // seq)
        keep = (a.keep != b.keep).reshape(-1, k).any(-1)
        if keep.any() and not ids.any():
            fail(f"{label}: keep masks differ in MoE call {call} with the "
                 f"same expert ids")
        rows |= {t // seq for t in keep.nonzero().flatten().tolist()}
    return rows, smallest


def _decode_requests(cfg, seed, prompt_lens=PROMPT_LENS):
    """DECODE_REQUESTS requests: prompt lengths (in ``prompt_lens``),
    new-token counts and token ids drawn from ``seed``."""
    import numpy as np
    from repro_torch.serving.batcher import Request
    rng = np.random.default_rng(seed)
    out = []
    for uid in range(DECODE_REQUESTS):
        n = int(rng.integers(prompt_lens[0], prompt_lens[1] + 1))
        out.append(Request(
            uid=uid, prompt=rng.integers(0, cfg.vocab_size, n).astype(np.int32),
            max_new_tokens=int(rng.integers(NEW_TOKENS[0],
                                            NEW_TOKENS[1] + 1))))
    return out


class _Timer:
    """CUDA-event pairs around device work; ``ms()`` after a sync."""

    def __init__(self):
        self.pairs = []

    def __enter__(self):
        import torch
        self.pairs.append((torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True)))
        self.pairs[-1][0].record()

    def __exit__(self, *exc):
        self.pairs[-1][1].record()

    def ms(self):
        import torch
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.pairs]


def _serve(cfg, model, requests, device, paged, seed):
    """Serve ``requests`` through DECODE_SLOTS slots with impl="kernel":
    the Batcher admits into free slots, each admission is prefilled (the
    whole prompt in one pass on the contiguous pool; chunks of
    PREFILL_CHUNK through decode_step on the paged one), then every live
    slot decodes one token per lockstep step. Returns the run's record."""
    import copy

    import numpy as np
    import torch
    from repro_torch.core.modes import Mode
    from repro_torch.models import lm
    from repro_torch.nn.module import Context
    from repro_torch.nn.moe import record_routing
    from repro_torch.serving.batcher import Batcher
    from repro_torch.serving.decode import uncertainty_decode
    from repro_torch.serving.engine import (DecodeStatePool,
                                            PagedDecodeStatePool)

    ctx = Context(mode=Mode.PFP, impl="kernel", device=device)
    if paged:
        pool = PagedDecodeStatePool(cfg, DECODE_SLOTS, DECODE_MAX_LEN,
                                    PAGE_SIZE, device=device)
    else:
        pool = DecodeStatePool(cfg, DECODE_SLOTS, DECODE_MAX_LEN,
                               device=device)
    batcher = Batcher(DECODE_SLOTS, DECODE_MAX_LEN)
    for req in requests:
        batcher.submit(copy.deepcopy(req))
    gen = torch.Generator(device=device).manual_seed(seed)
    last_token = np.zeros(DECODE_SLOTS, np.int64)
    prefill_t, step_t = _Timer(), _Timer()
    finished, steps, last_logits = [], 0, None
    routes = {"prefill": [], "step": []}   # MoE routing, for drop counts

    def record(slot, out, row):
        done = batcher.record(slot, int(out.token[row]),
                              float(out.mutual_info[row]),
                              bool(out.abstain[row]))
        last_token[slot] = int(out.token[row])
        if done is not None:
            pool.evict(slot)
            finished.append(done)

    def prefill(slot, prompt):
        n = len(prompt)
        if not paged:
            last, sub = lm.prefill(model, cfg, {"tokens": prompt[None]}, ctx,
                                   DECODE_MAX_LEN)
            pool.write_slot(slot, sub)
            return last
        for c0 in range(0, n, PREFILL_CHUNK):
            chunk = np.zeros((1, PREFILL_CHUNK), np.int32)
            part = prompt[c0:c0 + PREFILL_CHUNK]
            chunk[0, :len(part)] = part
            end = c0 + len(part)
            if not pool.ensure_capacity(slot, end):
                fail("decode: the page pool ran out of pages")
            logits, pool.states = lm.decode_step(model, cfg, {
                "tokens": chunk,
                "positions": (c0 + np.arange(PREFILL_CHUNK))[None],
                "cache_len": np.asarray([end]),
                "page_table": pool.device_table(np.asarray([slot])),
            }, pool.states, ctx)
        i = (n - 1) % PREFILL_CHUNK
        return type(logits)(logits.mean[:, i:i + 1], logits.second[:, i:i + 1],
                            logits.rep)

    while not batcher.idle:
        for slot, req in batcher.fill_slots():
            if pool.alloc(req.uid) != slot:
                fail("decode: pool and batcher disagree on the slot")
            with prefill_t, record_routing() as log:
                last = prefill(slot, req.prompt)
            routes["prefill"] += log
            pool.positions[slot] = len(req.prompt)
            record(slot, uncertainty_decode(last.mean, last.var, gen), 0)
        live = [slot for slot, _ in batcher.active()]
        if not live:
            continue
        positions = np.asarray(pool.positions, np.int64)
        active = np.zeros(DECODE_SLOTS, bool)
        active[live] = True
        inputs = {"tokens": np.where(active, last_token, 0)[:, None],
                  "positions": np.where(active, positions, 0)[:, None],
                  "cache_len": np.where(active, positions + 1, 0)}
        if paged:
            for slot in live:
                if not pool.ensure_capacity(slot,
                                            int(positions[slot]) + 1):
                    fail("decode: the page pool ran out of pages")
            inputs["page_table"] = pool.device_table()
        with step_t, record_routing() as log:
            logits, pool.states = lm.decode_step(model, cfg, inputs,
                                                 pool.states, ctx)
        routes["step"] += log
        steps += 1
        out = uncertainty_decode(logits.mean, logits.var, gen)
        last_logits = (logits.mean.clone(), logits.var.clone())
        for slot in live:
            pool.positions[slot] += 1
            record(slot, out, slot)
        pool.check_invariants()
    pool.check_invariants()
    if pool.live or (paged and pool.live_pages):
        fail(f"decode: slots {pool.live} / pages "
             f"{pool.live_pages if paged else 0} live after the drain")
    # MoE drop accounting (assignments dropped past capacity, of those
    # routed) over the prefills and over the decode steps.
    drops = {k: (sum(int((~r.keep).sum()) for r in v),
                 sum(r.keep.numel() for r in v)) for k, v in routes.items()}
    # Kept rows per expert of every decode step's MoE call (the counts
    # the expert MLP is given).
    step_rows = [torch.zeros(r.probs.shape[-1], dtype=torch.int32,
                             device=r.keep.device).scatter_add_(
        0, r.expert_idx.reshape(-1), r.keep.int()).tolist()
        for r in routes["step"]]
    return {"pool": "paged" if paged else "contiguous",
            "finished": sorted(finished, key=lambda r: r.uid),
            "steps": steps, "prefill_ms": prefill_t.ms(),
            "step_ms": step_t.ms(), "last_logits": last_logits,
            "moe_drops": drops, "step_rows": step_rows}


def _teacher_forced(cfg, model, requests, device):
    """Prefill and TEACHER_FORCED[1] fed tokens of the first
    TEACHER_FORCED[0] requests under both impls: max abs error of the
    kernel impl's logits against the eager impl's, (mean, var)."""
    import numpy as np
    import torch
    from repro_torch.core.modes import Mode
    from repro_torch.models import lm
    from repro_torch.nn.module import Context
    from repro_torch.nn.moe import record_routing
    errs = [0.0, 0.0]
    n_req, n_tok = TEACHER_FORCED
    compared = 0
    for req in requests[:n_req]:
        fed = np.asarray(req.generated[:n_tok], np.int64)
        outs, routes = {}, {}
        for impl in ("kernel", "eager"):
            ctx = Context(mode=Mode.PFP, impl=impl, device=device)
            with record_routing() as routes[impl]:
                last, states = lm.prefill(model, cfg,
                                          {"tokens": req.prompt[None]}, ctx,
                                          DECODE_MAX_LEN)
                logits = [last]
                for i, tok in enumerate(fed):
                    pos = len(req.prompt) + i
                    step, states = lm.decode_step(
                        model, cfg, {"tokens": np.asarray([[tok]]),
                                     "positions": np.asarray([[pos]])},
                        states, ctx)
                    logits.append(step)
            outs[impl] = logits
        # Each call's routing is over this one request's tokens (batch 1).
        flipped = set()
        for call, (a, b) in enumerate(zip(routes["kernel"], routes["eager"])):
            flipped |= compare_routes(f"decode uid {req.uid} call {call}",
                                      [a], [b], a.expert_idx.shape[0])[0]
        if flipped:
            print(f"[decode] uid {req.uid}: routing flipped at a near tie; "
                  f"its logits are not compared")
            continue
        compared += 1
        for got, want in zip(outs["kernel"], outs["eager"]):
            for i, part in enumerate(("mean", "var")):
                g, w = getattr(got, part), getattr(want, part)
                rtol, atol = MODEL_TOL[part]
                if not torch.isfinite(g).all() or \
                        not torch.allclose(g, w, rtol=rtol, atol=atol):
                    fail(f"decode uid {req.uid}: kernel vs eager {part} "
                         f"logits, max abs err "
                         f"{float((g - w).abs().max()):.3e}")
                errs[i] = max(errs[i], float((g - w).abs().max()))
    if not compared:
        fail("decode: no teacher-forced request left to compare")
    return errs


def phase_decode(device, cfg, model, seed, *, prompt_lens=PROMPT_LENS,
                 kernels=DECODE_KERNELS, tag="decode"):
    """The decode path through both pools; launch counts per run, the
    paged-vs-contiguous and kernel-vs-eager checks, times and a profile of
    one decode step. Every kernel of ``kernels`` must launch in each pool's
    run (the cache kernel in the contiguous one, the paged kernel in the
    paged one)."""
    import numpy as np
    import torch
    from repro_torch.core.modes import Mode
    from repro_torch.kernels._launch import LAUNCHES, reset_launch_counts
    from repro_torch.models import lm
    from repro_torch.nn.module import Context

    requests = _decode_requests(cfg, seed, prompt_lens)
    # Every decode step streams each dense weight's mean and SRM once (the
    # embedding is gathered, not streamed): the dense kernels' bound.
    weight_bytes = 8 * (cfg.param_count() - cfg.vocab_size * cfg.d_model)
    print(f"[{tag}] a decode step reads {weight_bytes / 1e9:.3f} GB of "
          f"dense weight means and SRMs: bound "
          f"{weight_bytes / PEAK_BYTES * 1e3:.4f} ms")
    print(f"[{tag}] {DECODE_REQUESTS} requests, prompts "
          f"{[len(r.prompt) for r in requests]}, new tokens "
          f"{[r.max_new_tokens for r in requests]}; {DECODE_SLOTS} slots of "
          f"{DECODE_MAX_LEN} rows")
    runs, launches = {}, {}
    for paged in (False, True):
        reset_launch_counts()
        t0 = time.perf_counter()
        run = _serve(cfg, model, requests, device, paged, seed)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = {k: LAUNCHES[k] for k in kernels}
        name = run["pool"]
        runs[name], launches[name] = run, counts
        tokens = sum(len(r.generated) for r in run["finished"])
        print(f"[{tag}] {name}: {len(run['finished'])} requests finished "
              f"({', '.join(sorted({r.finish_reason for r in run['finished']}))}"
              f"), {tokens} tokens in {run['steps']} lockstep steps, "
              f"{seconds:.2f} s; step {np.mean(run['step_ms']):.3f} ms mean "
              f"(CUDA events, {len(run['step_ms'])} steps), prefill "
              f"{np.mean(run['prefill_ms']):.2f} ms per prompt; launches "
              f"{counts}")
        if "dense_batched" in kernels:
            print(f"[{tag}] {name}: moe_dropped / moe_assignments: prefills "
                  f"{run['moe_drops']['prefill']}, decode steps "
                  f"{run['moe_drops']['step']}")
        if len(run["finished"]) != DECODE_REQUESTS:
            fail(f"{tag} {name}: {len(run['finished'])} of "
                 f"{DECODE_REQUESTS} requests finished")
    cont, paged = runs["contiguous"], runs["paged"]
    for name, other in (("contiguous", "attention_paged"),
                        ("paged", "attention_cache")):
        missing = [k for k in kernels if k != other
                   and launches[name][k] == 0]
        if missing:
            fail(f"{tag}: kernels never launched on the {name} pool: "
                 f"{missing}")
    for a, b in zip(cont["finished"], paged["finished"]):
        if a.generated != b.generated:
            fail(f"{tag} uid {a.uid}: paged tokens {b.generated} != "
                 f"contiguous {a.generated}")
    if not all(torch.equal(a, b) for a, b in zip(cont["last_logits"],
                                                 paged["last_logits"])):
        fail(f"{tag}: paged and contiguous last-step logits differ")
    print(f"[{tag}] paged and contiguous: identical tokens, "
          f"bit-identical last-step logits")
    occupancy = None
    if "dense_batched" in kernels:
        # The expert kernel skips experts without a row; the same requests
        # with the skip off must give the same tokens and logits.
        from repro_torch.nn.moe import empty_expert_skip
        with empty_expert_skip(False):
            plain = _serve(cfg, model, requests, device, False, seed)
        for a, b in zip(cont["finished"], plain["finished"]):
            if a.generated != b.generated:
                fail(f"{tag} uid {a.uid}: tokens {a.generated} with the "
                     f"empty-expert skip, {b.generated} without")
        if not all(torch.equal(a, b) for a, b in zip(cont["last_logits"],
                                                     plain["last_logits"])):
            fail(f"{tag}: last-step logits differ with the skip off")
        held = sorted(sum(1 for c in r if c) for r in cont["step_rows"])
        occupancy = {"experts_held": held,
                     "median_rows": sorted(
                         cont["step_rows"],
                         key=lambda r: sum(1 for c in r if c))[len(held) // 2],
                     "step_ms_skip_off": plain["step_ms"]}
        print(f"[{tag}] empty-expert skip off: identical tokens, bit-identical"
              f" last-step logits; step {np.mean(plain['step_ms']):.3f} ms "
              f"mean against {np.mean(cont['step_ms']):.3f} with it; experts "
              f"holding a row per decode MoE call: min {held[0]}, median "
              f"{held[len(held) // 2]}, max {held[-1]} of "
              f"{len(cont['step_rows'][0])} ({len(held)} calls)")
    for r in cont["finished"]:
        print(f"[{tag}]   uid {r.uid}: {len(r.prompt)} + "
              f"{len(r.generated)} tokens ({r.finish_reason}), mean MI "
              f"{np.mean(r.mi_trace):.4e}, first tokens {r.generated[:6]}")
    tf = _teacher_forced(cfg, model, cont["finished"], device)
    print(f"[{tag}] teacher-forced kernel vs eager logits ("
          f"{TEACHER_FORCED[0]} requests, prefill + {TEACHER_FORCED[1]} "
          f"tokens): max abs err mean {tf[0]:.3e}, var {tf[1]:.3e}")

    # Launches in one lockstep decode step and one prefill of each pool,
    # and a profile of one decode step (stale cache rows: only the time
    # is read).
    ctx = Context(mode=Mode.PFP, impl="kernel", device=device)
    pos = np.asarray([300, 400, 500, 540])
    step_inputs = {"tokens": np.ones((DECODE_SLOTS, 1), np.int64),
                   "positions": pos[:, None], "cache_len": pos + 1}
    states = lm.init_decode_state(cfg, DECODE_SLOTS, DECODE_MAX_LEN,
                                  device=device)
    per_step = {}
    reset_launch_counts()
    lm.decode_step(model, cfg, step_inputs, states, ctx)
    per_step["decode_step"] = {k: v for k, v in LAUNCHES.items() if v}
    reset_launch_counts()
    lm.prefill(model, cfg, {"tokens": requests[0].prompt[None]}, ctx,
               DECODE_MAX_LEN)
    per_step["prefill"] = {k: v for k, v in LAUNCHES.items() if v}
    print(f"[{tag}] launches per contiguous decode step "
          f"{per_step['decode_step']}; per prefill {per_step['prefill']}")
    profile = _profile(f"{cfg.name} decode step B={DECODE_SLOTS}",
                       lambda: lm.decode_step(model, cfg, step_inputs, states,
                                              ctx), 5, 2)
    info = {
        "requests": [{"uid": r.uid, "prompt": len(r.prompt),
                      "new": r.max_new_tokens, "generated": r.generated,
                      "mi": r.mi_trace, "finish": r.finish_reason}
                     for r in cont["finished"]],
        "step_ms": {k: v["step_ms"] for k, v in runs.items()},
        "prefill_ms": {k: v["prefill_ms"] for k, v in runs.items()},
        "launches": launches, "per_call_launches": per_step,
        "teacher_forced_err": tf, "profile": profile,
        "step_weight_bytes": weight_bytes,
        "step_bound_ms": weight_bytes / PEAK_BYTES * 1e3,
    }
    info["moe_drops"] = {k: v["moe_drops"] for k, v in runs.items()}
    if occupancy is not None:
        info["occupancy"] = occupancy
    total = {k: launches["contiguous"][k] + launches["paged"][k]
             for k in kernels}
    return total, info


def moe_config():
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(MOE_ARCH), num_layers=MOE_LAYERS,
                               sigma_init=1e-3)


def _moe_model(device):
    """deepseek-moe-16b at full width, cut to MOE_LAYERS layers: random
    variational weights drawn on the card from a seed, converted to PFP."""
    import torch
    from repro_torch.bayes.convert import svi_to_pfp
    from repro_torch.models import lm
    cfg = moe_config()
    variational = lm.init_params(
        cfg, generator=torch.Generator(device=device).manual_seed(0),
        device=device)
    model = svi_to_pfp(variational, calibration_factor=CALIBRATION)
    del variational
    return cfg, model


def _moe_forward_check(label, cfg, model, tokens, device, formulation,
                       kernel_out, kernel_routes):
    """The eager impl on the same tokens: routing compared first, then the
    logits of the rows the routing left comparable, at model tolerance.
    Returns (max abs err mean, var, rows left out, smallest margin)."""
    import torch
    from repro_torch.core.modes import Mode
    from repro_torch.models import lm
    from repro_torch.nn.module import Context
    from repro_torch.nn.moe import record_routing
    ctx = Context(mode=Mode.PFP, impl="eager", formulation=formulation,
                  device=device)
    with record_routing() as eager_routes:
        ref_out, _, _ = lm.forward(model, cfg, {"tokens": tokens}, ctx)
    rows, margin = compare_routes(label, kernel_routes, eager_routes,
                                  tokens.shape[1])
    keep = [b for b in range(tokens.shape[0]) if b not in rows]
    if not keep:
        fail(f"{label}: no batch row left with the same routing")
    errs = []
    for part in ("mean", "var"):
        got, want = getattr(kernel_out, part), getattr(ref_out, part)
        if tuple(got.shape) != (*tokens.shape, cfg.vocab_size) or \
                not torch.isfinite(got).all():
            fail(f"{label} {part}: bad logits {tuple(got.shape)}")
        got, want = got[keep], want[keep]
        rtol, atol = MODEL_TOL[part]
        err = float((got - want).abs().max())
        errs.append(err)
        if not torch.allclose(got, want, rtol=rtol, atol=atol):
            fail(f"{label} {part} kernel vs eager: max abs err {err:.3e}")
    if float(kernel_out.var.min()) <= 0:
        fail(f"{label}: non-positive logit variance")
    print(f"[moe] {label}: routing equal in {len(kernel_routes)} MoE calls"
          f"{f' but rows {sorted(rows)}' if rows else ''} (smallest top-"
          f"{cfg.top_k} margin {margin:.3e}); kernel vs eager logits of rows "
          f"{keep}: max abs err mean {errs[0]:.3e}, var {errs[1]:.3e}")
    return errs[0], errs[1], sorted(rows), margin


def phase_moe(device):
    """The MoE path: (a) deepseek-moe-16b PFP forwards (Eq. 12) with the
    kernels, next token and Eq. 1-3 at the last position; (b) one forward
    with formulation="var" (Eq. 7). Each held against impl="eager" after
    the routing comparison; the batched expert kernel must launch."""
    import torch
    from repro_torch.bayes import metrics
    from repro_torch.core.modes import Mode
    from repro_torch.kernels._launch import LAUNCHES, reset_launch_counts
    from repro_torch.models import lm
    from repro_torch.nn.module import Context
    from repro_torch.nn.moe import record_routing

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, model = _moe_model(device)
    torch.cuda.synchronize()
    moe_layers = sum(cfg.layer_kind(i) == "moe" for i in range(cfg.num_layers))
    print(f"[moe] {cfg.name}: d_model {cfg.d_model}, {cfg.num_heads} heads "
          f"of {cfg.head_dim}, {cfg.num_experts} routed experts top-"
          f"{cfg.top_k} + {cfg.num_shared_experts} shared, d_ff {cfg.d_ff}, "
          f"vocab {cfg.vocab_size}, {cfg.num_layers} layers (cut from 28: "
          f"layer 0 dense, {moe_layers} MoE); {cfg.param_count() / 1e6:.1f} "
          f"M weights drawn on the card and converted in "
          f"{time.perf_counter() - t0:.2f} s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    requests = _lm_requests(cfg, device)
    info = {"formulations": {}}
    launches = {}
    for formulation, reqs in (("srm", requests), ("var", requests[:1])):
        # Eq. 7 runs the dense kernels' var modes.
        path = [k + "_var" if formulation == "var" and k.startswith("dense")
                else k for k in MOE_KERNELS]
        kernel = path[-1]
        ctx = Context(mode=Mode.PFP, impl="kernel", formulation=formulation,
                      device=device)
        outs = []
        reset_launch_counts()
        t0 = time.perf_counter()
        with record_routing() as routes:
            for tokens in reqs:
                logits, aux, _ = lm.forward(model, cfg, {"tokens": tokens},
                                            ctx)
                last_mu, last_var = logits.mean[:, -1], logits.var[:, -1]
                gen = torch.Generator(device=device).manual_seed(1)
                unc = metrics.pfp_predictive_metrics(gen, last_mu, last_var,
                                                     100)
                outs.append((logits, aux, torch.argmax(last_mu, dim=-1),
                             unc))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = {k: v for k, v in LAUNCHES.items() if v}
        launches[formulation] = counts
        missing = [k for k in path if counts.get(k, 0) == 0]
        want = len(reqs) * 3 * moe_layers
        print(f"[moe] {formulation}: {len(reqs)} requests of {LM_BATCH} x "
              f"{LM_SEQ} tokens in {seconds:.3f} s (first calls included); "
              f"launches {counts}")
        if missing or counts.get(kernel) != want:
            fail(f"MoE {formulation}: kernels never launched {missing}, or "
                 f"{kernel} launched {counts.get(kernel)} times, not {want}")
        for i, (_, aux, next_tok, unc) in enumerate(outs):
            print(f"[moe] {formulation} request {i}: next tokens "
                  f"{next_tok.tolist()}, MI "
                  + ", ".join(f"{float(v):.4e}" for v in unc["mi"])
                  + f"; moe_dropped {float(aux['moe_dropped']):.0f} of "
                  f"{float(aux['moe_assignments']):.0f} assignments, loss "
                  f"{float(aux['loss']):.4f}")
        # Request i's MoE calls are entries i * moe_layers onwards of the
        # log; every request is held against eager.
        checks = [_moe_forward_check(
            f"{formulation} request {i}", cfg, model, tokens, device,
            formulation, out[0], routes[i * moe_layers:(i + 1) * moe_layers])
            for i, (tokens, out) in enumerate(zip(reqs, outs))]
        info["formulations"][formulation] = {
            "seconds": seconds, "launches": counts,
            "errors": [c[:2] for c in checks],
            "rows_left_out": [c[2] for c in checks],
            "smallest_margin": min(c[3] for c in checks),
            "next_tokens": [o[2].tolist() for o in outs],
            "mi": [o[3]["mi"].tolist() for o in outs],
            "moe_dropped": [float(o[1]["moe_dropped"]) for o in outs],
            "moe_assignments": [float(o[1]["moe_assignments"])
                                for o in outs]}
        del outs
    info["peak_gb_forward"] = torch.cuda.max_memory_allocated() / 1e9
    print(f"[moe] peak memory after the forwards "
          f"{info['peak_gb_forward']:.2f} GB")
    return launches, info, cfg, model


def phase_moe_times(device, cfg, model, decode_rows):
    """The batched kernels at the MoE shapes (device times beside plain,
    library and bound, and the eager call), and at the decode shapes with
    ``decode_rows`` (one decode MoE call's kept rows per expert, the
    median occupancy of the decode phase); the MoE forward eager and in a
    CUDA graph."""
    import torch
    from repro_torch.core.modes import Mode
    from repro_torch.models import lm
    from repro_torch.nn.module import Context
    rows = []
    for kernel in BATCHED_KERNELS:
        for shape in MOE_SHAPES:
            big = shape[1] > 100    # ~0.27 TFLOP a call
            rows.append(_time_row("moe", kernel, shape, device,
                                  inner=2 if big else 10,
                                  replays=2 if big else 5,
                                  call_iters=3 if big else 30))
        for shape in (MOE_DECODE_UP, MOE_DECODE_DOWN):
            rows.append(_time_row("moe-occ", kernel, shape, device,
                                  rows=decode_rows))
    rows.append(_time_row("moe-decode", "rmsnorm", norm_decode_calls(cfg)[0],
                          device))
    tokens = _lm_requests(cfg, device)[0]
    row = {"batch": LM_BATCH, "seq": LM_SEQ, "model": cfg.name}
    for impl, iters in (("kernel", 3), ("eager", 2)):
        ctx = Context(mode=Mode.PFP, impl=impl, device=device)
        row[f"{impl}_ms"] = time_ms(
            lambda: lm.forward(model, cfg, {"tokens": tokens}, ctx),
            iters=iters, warmup=1)
    ctx = Context(mode=Mode.PFP, impl="kernel", device=device)
    row["kernel_graph_ms"] = device_ms(
        lambda: lm.forward(model, cfg, {"tokens": tokens}, ctx),
        inner=1, replays=3)
    row["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print(f"[times] forward {cfg.name} ({cfg.num_layers} layers) B={LM_BATCH}"
          f" T={LM_SEQ} kernel {row['kernel_ms']:.2f} ms  eager "
          f"{row['eager_ms']:.2f} ms  kernel in a CUDA graph "
          f"{row['kernel_graph_ms']:.2f} ms; peak memory {row['peak_gb']:.2f}"
          f" GB")
    profile = _profile(f"{cfg.name} B={LM_BATCH} T={LM_SEQ}",
                       lambda: lm.forward(model, cfg, {"tokens": tokens},
                                          ctx), 2, 1)
    return rows, row, profile


def _time_row(label, kernel, shape, device, inner=10, replays=5,
              call_iters=30, rows=None):
    """Device ms of the kernel, its plain version and the library call at
    one shape, its bound, and its time per eager call. ``rows``: the
    batched kernel's kept rows per expert (the rest of x zeroed, as the
    MoE dispatch leaves it; the bound counts what these rows need)."""
    import torch
    args = operands(kernel, shape, 1, device)
    rows_t = None
    if rows is not None:
        rows_t = torch.tensor(rows, dtype=torch.int32, device=device)
        keep = (torch.arange(shape[1], device=device)[None, :, None]
                < rows_t[:, None, None])
        args = tuple(torch.where(keep, a, 0.0) if i < 2 else a
                     for i, a in enumerate(args))
    lib = library_call(kernel, args)
    row = {
        "batch": label, "kernel": kernel, "shape": list(shape),
        "ms": device_ms(lambda: run_kernel(kernel, args, rows_t), inner,
                        replays),
        "plain_ms": device_ms(lambda: run_plain(kernel, args, rows_t),
                              inner, replays),
        "library_ms": device_ms(lib, inner, replays) if lib else None,
        "call_ms": time_ms(lambda: run_kernel(kernel, args, rows_t),
                           call_iters, min(3, call_iters)),
    }
    lim = limits(kernel, shape, rows)
    row["bound_ms"], row["bound_by"], row["bound_limit"] = _bound(lim)
    if kernel in SASS_KERNELS or kernel in NORM_OPS:
        row["limits"], row["floor_ms"] = lim, FLOOR_MS
    plan = dense_plan_of(kernel, shape)
    if plan is not None:
        row["plan"] = list(plan)
    if kernel in CACHE_KERNELS:
        row["attention_plan"] = attention_plan_line(label, kernel, shape)
    if rows is not None:
        row["rows"] = list(rows)
    lib_s = "-" if lib is None else f"{row['library_ms']:.4f}"
    plan_s = "" if plan is None else f"  plan {plan}"
    occ_s = ("" if rows is None else
             f"  ({sum(1 for r in rows if r)} experts hold {sum(rows)} rows)")
    floor_s = ("" if kernel not in SASS_KERNELS else
               f"  floor {FLOOR_MS:.4f}  (bytes {lim['bytes']:.5f}, issue "
               f"{lim['issue']:.5f}, mufu {lim['mufu']:.5f})")
    if kernel in NORM_OPS:
        floor_s = f"  floor {FLOOR_MS:.4f}  (bytes {lim['bytes']:.5f})"
    print(f"[times] B={label:<5} {kernel:18s} {str(shape):36s} kernel "
          f"{row['ms']:.4f} ms  plain {row['plain_ms']:.4f}  library {lib_s}"
          f"  bound {row['bound_ms']:.5f} ({row['bound_limit']})  eager call "
          f"{row['call_ms']:.4f}{plan_s}{occ_s}{floor_s}")
    return row


def phase_times(device, lm_cfg, lm_model):
    """Per-(kernel, shape) times at each batch of the CNN path and at the
    LM's shapes, and whole-model forwards.

    ``ms``, ``plain_ms`` and ``library_ms`` are device times (CUDA graph
    replays); ``call_ms`` is the kernel's time per eager call, host work
    included."""
    import torch
    from repro_torch.core.modes import Mode
    from repro_torch.models import lm
    from repro_torch.kernels._launch import launch_empty
    from repro_torch.nn.module import Context
    global FLOOR_MS
    FLOOR_MS = device_ms(lambda: launch_empty(device))
    print(f"[times] empty kernel (csrc/pfp_floor.cu): {FLOOR_MS:.4f} ms a "
          f"launch in a CUDA graph, the floor no launch goes under")
    rows = []
    for batch in BATCHES:
        seen = set()
        for formulation in ("srm", "var"):
            for kernel, shape in main_path_calls(batch, formulation):
                if (kernel, shape) not in seen:
                    seen.add((kernel, shape))
                    rows.append(_time_row(batch, kernel, shape, device))
    seen = set()
    for kernel, shape in lm_path_calls(lm_cfg) + [("layernorm", (
            LM_BATCH * LM_SEQ, lm_cfg.d_model))]:
        if (kernel, shape) in seen:
            continue
        seen.add((kernel, shape))
        big = kernel == "dense"   # up to 2.5 TFLOP a call at these shapes
        rows.append(_time_row("lm", kernel, shape, device,
                              inner=2 if big else 10, replays=2 if big else 5,
                              call_iters=3 if big else 30))
    # Row 2 (Eq. 7) at the LM's dense shapes: on no path of these models,
    # timed for its plain version and library call beside the kernel.
    for shape in dict.fromkeys(s for k, s in lm_path_calls(lm_cfg)
                               if k == "dense"):
        rows.append(_time_row("lm", "dense_var", shape, device, inner=2,
                              replays=2, call_iters=3))
    for shape in dict.fromkeys(lm_decode_calls(lm_cfg)):
        rows.append(_time_row("lm-decode", "dense", shape, device))
    # Row 6 at granite's 4-slot decode step (deepseek's: phase_moe_times).
    rows.append(_time_row("lm-decode", "rmsnorm",
                          norm_decode_calls(lm_cfg)[0], device))
    for shape in dict.fromkeys(lm_chunk_calls(lm_cfg)):
        rows.append(_time_row("lm-chunk", "dense", shape, device))
    for kernel in CACHE_KERNELS:
        paged = (PAGE_SIZE,) if kernel == "attention_paged" else ()
        for label, shape in (("decode", CACHE_DECODE),
                             ("decode-moe", CACHE_DECODE_MOE),
                             ("prefill", CACHE_PREFILL)):
            rows.append(_time_row(label, kernel, shape + paged, device))
    models = _models(device)
    forwards = []
    for batch in BATCHES:
        x = torch.rand((batch, 28, 28), generator=torch.Generator()
                       .manual_seed(batch)).to(device)
        for name, model in models.items():
            xin = _requests(name, x)
            row = {"batch": batch, "model": name}
            for impl in ("kernel", "eager"):
                ctx = Context(mode=Mode.PFP, impl=impl, device=device)
                row[f"{impl}_ms"] = time_ms(lambda: model(xin, ctx), iters=20)
            ctx = Context(mode=Mode.PFP, impl="kernel", device=device)
            row["kernel_graph_ms"] = device_ms(lambda: model(xin, ctx))
            forwards.append(row)
            print(f"[times] forward {name:6s} B={batch:<5d} kernel "
                  f"{row['kernel_ms']:.4f} ms  eager {row['eager_ms']:.4f} ms"
                  f"  kernel in a CUDA graph {row['kernel_graph_ms']:.4f} ms")
    del models
    tokens = _lm_requests(lm_cfg, device)[0]
    row = {"batch": LM_BATCH, "seq": LM_SEQ, "model": lm_cfg.name}
    for impl, iters in (("kernel", 3), ("eager", 2)):
        ctx = Context(mode=Mode.PFP, impl=impl, device=device)
        row[f"{impl}_ms"] = time_ms(
            lambda: lm.forward(lm_model, lm_cfg, {"tokens": tokens}, ctx),
            iters=iters, warmup=1)
    ctx = Context(mode=Mode.PFP, impl="kernel", device=device)
    row["kernel_graph_ms"] = device_ms(
        lambda: lm.forward(lm_model, lm_cfg, {"tokens": tokens}, ctx),
        inner=1, replays=3)
    forwards.append(row)
    print(f"[times] forward {lm_cfg.name} ({lm_cfg.num_layers} layers) "
          f"B={LM_BATCH} T={LM_SEQ} kernel {row['kernel_ms']:.2f} ms  eager "
          f"{row['eager_ms']:.2f} ms  kernel in a CUDA graph "
          f"{row['kernel_graph_ms']:.2f} ms")
    return rows, forwards


def _profile(label, fn, reps, warmup):
    """torch.profiler over ``reps`` calls of ``fn``: wall and device-busy
    ms per call and the kernels that take the device time. The wall time
    includes the profiler's own cost."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy_ms == 0:
        print(f"[profile] {label}: the profiler saw no device time")
        return None
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
    launched = sum(e.count for e in kernels) / reps
    print(f"[profile] {label}, {reps} forwards: wall {wall_ms / reps:.4f} ms, "
          f"device busy {busy_ms / reps:.4f} ms per forward "
          f"({100 * busy_ms / wall_ms:.1f}% busy), {launched:g} device "
          f"kernels per forward; the top five:")
    for e in top:
        print(f"[profile]   {e.self_device_time_total / 1e3 / reps:9.4f}"
              f" ms x{e.count // reps:<3d} {e.key[:80]}")
    return {"wall_ms": wall_ms / reps, "busy_ms": busy_ms / reps,
            "kernels": launched,
            "top": [(e.key, e.self_device_time_total / 1e3 / reps,
                     e.count // reps) for e in top]}


def phase_profile(device, lm_cfg, lm_model, reps=10):
    """The profiler over kernel-impl forwards of each CNN at each batch
    and of the LM."""
    import torch
    from repro_torch.core.modes import Mode
    from repro_torch.models import lm
    from repro_torch.nn.module import Context
    models = _models(device)
    ctx = Context(mode=Mode.PFP, impl="kernel", device=device)
    out = []
    for batch in BATCHES:
        x = torch.rand((batch, 28, 28), generator=torch.Generator()
                       .manual_seed(3)).to(device)
        for name, model in models.items():
            xin = _requests(name, x)
            row = _profile(f"{name:6s} B={batch:<5d}", lambda: model(xin, ctx),
                           reps, 3)
            if row is not None:
                out.append({"model": name, "batch": batch, **row})
    tokens = _lm_requests(lm_cfg, device)[0]
    row = _profile(f"{lm_cfg.name} B={LM_BATCH} T={LM_SEQ}",
                   lambda: lm.forward(lm_model, lm_cfg, {"tokens": tokens},
                                      ctx), 2, 1)
    if row is not None:
        out.append({"model": lm_cfg.name, "batch": LM_BATCH, **row})
    return out


# ---------------------------------------------------------------------------
# The audio decoder: musicgen-medium at full width and depth
# ---------------------------------------------------------------------------
def _audio_frames(shape, seed, device):
    """Seeded N(0, 1) frame embeddings on ``device``."""
    import torch
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(device)


def _audio_model(device):
    """musicgen-medium at full width and all 48 layers: random variational
    weights drawn on the card from a seed (none can be downloaded),
    converted to PFP."""
    import torch
    from repro_torch.bayes.convert import svi_to_pfp
    from repro_torch.models import lm
    cfg = audio_config()
    variational = lm.init_params(
        cfg, generator=torch.Generator(device=device).manual_seed(0),
        device=device)
    model = svi_to_pfp(variational, calibration_factor=CALIBRATION)
    del variational
    return cfg, model


def _model_errs(label, got, want):
    """Max abs error of kernel-impl logits (mean, var) against the eager
    impl's, and whether each of mean and var lies within MODEL_TOL. Fails
    on a bad shape or a non-finite value."""
    import torch
    errs, within = {}, {}
    for part, g, w in zip(("mean", "var"), got, want):
        if g.shape != w.shape or not torch.isfinite(g).all():
            fail(f"{label} {part}: shape {tuple(g.shape)} vs "
                 f"{tuple(w.shape)} or non-finite logits")
        rtol, atol = MODEL_TOL[part]
        errs[part] = float((g - w).abs().max())
        within[part] = bool(torch.allclose(g, w, rtol=rtol, atol=atol))
    return errs, within


def _audio_stages(model, cfg, frames, ctx):
    """The forward's states, as lm.forward computes them: the frames plus
    the sinusoid, each block's output, the logits."""
    from repro_torch.models import lm
    x, positions, standard = lm._embed_inputs(
        model, cfg, {"frame_embeddings": frames}, ctx)
    stages = [x]
    for name, _, group in lm._layers(cfg):
        block = (getattr(model, name) if group is None
                 else model.stack[group][name])
        x, _, _ = lm._block_apply(block, x, ctx, cfg, positions=positions,
                                  standard_positions=standard)
        stages.append(x)
    stages.append(model.lm_head(model.ln_f(x, ctx), ctx))
    return stages


def _fp64_stage_check(cfg, model, frames, device, logits_within):
    """The train phase's fp64 rule, stage by stage: the kernel impl's
    states no further from an fp64 eager forward (a float64 copy of the
    same converted weights, the same frames) than FP64_FACTOR times the
    fp32 eager impl's, at the embedding, after every block and at the logits.
    It is the gate only where the logits are outside MODEL_TOL of the eager
    impl; the errors are printed either way. Returns them by stage."""
    import copy

    import torch
    from repro_torch.core.modes import Mode
    from repro_torch.nn.module import Context
    runs = {}
    for impl in ("kernel", "eager"):
        ctx = Context(mode=Mode.PFP, impl=impl, device=device)
        runs[impl] = [(x.mean, x.var) for x in
                      _audio_stages(model, cfg, frames, ctx)]
    exact = copy.deepcopy(model).double()
    ctx = Context(mode=Mode.PFP, impl="eager", device=device)
    ref64 = _audio_stages(exact, cfg, frames.double(), ctx)
    del exact
    out, worst = [], (0.0, None)
    for i, x64 in enumerate(ref64):
        e = {}
        for impl, states in runs.items():
            e[impl] = [float((a.double() - b).abs().max())
                       for a, b in zip(states[i], (x64.mean, x64.var))]
        out.append(e)
        for j, part in enumerate(("mean", "var")):
            ratio = e["kernel"][j] / max(e["eager"][j], 1e-30)
            if ratio > worst[0]:
                worst = (ratio, (i, part))
            if (not logits_within and e["kernel"][j]
                    > FP64_FACTOR * max(e["eager"][j], 1e-12)):
                fail(f"audio forward stage {i} {part}: kernel impl "
                     f"{e['kernel'][j]:.3e} from fp64, the eager impl "
                     f"{e['eager'][j]:.3e} (> {FP64_FACTOR}x)")
    torch.cuda.synchronize()
    last = len(out) - 1
    for i in sorted({0, 1, last // 4, last // 2, 3 * last // 4, last - 1,
                     last}):
        name = ("embedding" if i == 0 else "logits" if i == last
                else f"after block {i}")
        k, e = out[i]["kernel"], out[i]["eager"]
        print(f"[audio] vs fp64 at {name}: kernel mean {k[0]:.3e} var "
              f"{k[1]:.3e}; eager mean {e[0]:.3e} var {e[1]:.3e}")
    gate = ("only printed: MODEL_TOL held" if logits_within
            else "held at every stage")
    print(f"[audio] fp64 rule (kernel no further than {FP64_FACTOR}x eager "
          f"at every stage): largest ratio {worst[0]:.2f} at stage "
          f"{worst[1]}; the gate {gate}")
    return out


def _audio_serve(cfg, model, prompts, steps, device, paged, impl="kernel"):
    """DECODE_SLOTS prompts (frame embeddings (n, d_model)) through a pool:
    each prefilled alone in chunks of PREFILL_CHUNK through decode_step
    (contiguous: on the slot's view, written back; paged: through its page
    table), then one lockstep decode_step a frame of ``steps`` ((B, 1,
    d_model) each) for every slot. Every pass's logits, CUDA-event ms per
    prompt and per step."""
    import numpy as np
    import torch
    from repro_torch.core.modes import Mode
    from repro_torch.models import lm
    from repro_torch.nn.module import Context
    from repro_torch.serving.engine import (DecodeStatePool,
                                            PagedDecodeStatePool)
    ctx = Context(mode=Mode.PFP, impl=impl, device=device)
    if paged:
        pool = PagedDecodeStatePool(cfg, DECODE_SLOTS, DECODE_MAX_LEN,
                                    PAGE_SIZE, device=device)
    else:
        pool = DecodeStatePool(cfg, DECODE_SLOTS, DECODE_MAX_LEN,
                               device=device)
    prefill_t, step_t, outs = _Timer(), _Timer(), []
    for uid, prompt in enumerate(prompts):
        slot, n = pool.alloc(uid), prompt.shape[0]
        with prefill_t:
            sub = None if paged else pool.take_slot(slot)
            for c0 in range(0, n, PREFILL_CHUNK):
                end = min(n, c0 + PREFILL_CHUNK)
                chunk = torch.zeros((1, PREFILL_CHUNK, cfg.d_model),
                                    device=device)
                chunk[0, :end - c0] = prompt[c0:end]
                inputs = {"frame_embeddings": chunk,
                          "positions": (c0 + np.arange(PREFILL_CHUNK))[None],
                          "cache_len": np.asarray([end])}
                if paged:
                    if not pool.ensure_capacity(slot, end):
                        fail("audio: the page pool ran out of pages")
                    inputs["page_table"] = pool.device_table(
                        np.asarray([slot]))
                    logits, pool.states = lm.decode_step(
                        model, cfg, inputs, pool.states, ctx)
                else:
                    logits, sub = lm.decode_step(model, cfg, inputs, sub,
                                                 ctx)
                outs.append((logits.mean, logits.var))
            if not paged:
                pool.write_slot(slot, sub)
        pool.positions[slot] = n
    for frames in steps:
        pos = np.asarray(pool.positions, np.int64)
        inputs = {"frame_embeddings": frames, "positions": pos[:, None],
                  "cache_len": pos + 1}
        if paged:
            for slot in range(DECODE_SLOTS):
                if not pool.ensure_capacity(slot, int(pos[slot]) + 1):
                    fail("audio: the page pool ran out of pages")
            inputs["page_table"] = pool.device_table()
        with step_t:
            logits, pool.states = lm.decode_step(model, cfg, inputs,
                                                 pool.states, ctx)
        outs.append((logits.mean, logits.var))
        for slot in range(DECODE_SLOTS):
            pool.positions[slot] += 1
        pool.check_invariants()
    for slot in range(DECODE_SLOTS):
        pool.evict(slot)
    pool.check_invariants()
    if pool.live or (paged and pool.live_pages):
        fail("audio: slots or pages live after the evictions")
    return {"logits": outs, "prefill_ms": prefill_t.ms(),
            "step_ms": step_t.ms()}


def phase_audio(device):
    """musicgen-medium at full width and all 48 layers: a 4 x 512-frame
    forward through the kernels held against the eager impl (MODEL_TOL, or
    the fp64 rule stage by stage), its launches; DECODE_SLOTS prompts of
    AUDIO_PROMPTS frames prefilled in chunks of PREFILL_CHUNK and
    AUDIO_STEPS lockstep steps fed seeded frames on both pools (paged
    equal to contiguous bit for bit, kernel impl against eager at
    MODEL_TOL); a whole-prompt prefill; times, profiles, peak memory, and
    the kernels' times at the path's shapes. Returns (launches by path,
    info, timing rows, forward row, profiles, cfg)."""
    import numpy as np
    import torch
    from repro_torch.bayes import metrics
    from repro_torch.core.modes import Mode
    from repro_torch.kernels._launch import LAUNCHES, reset_launch_counts
    from repro_torch.models import lm
    from repro_torch.nn.module import Context
    from repro_torch.serving.decode import uncertainty_decode

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, model = _audio_model(device)
    torch.cuda.synchronize()
    print(f"[audio] {cfg.name}: d_model {cfg.d_model}, {cfg.num_heads}/"
          f"{cfg.num_kv_heads} heads of {cfg.head_dim}, d_ff {cfg.d_ff} "
          f"(gelu, ungated), LayerNorm, sinusoidal positions, vocab "
          f"{cfg.vocab_size}, all {cfg.num_layers} layers, frame embeddings "
          f"in; {cfg.param_count() / 1e6:.1f} M weights drawn on the card "
          f"(random: none can be downloaded) and converted in "
          f"{time.perf_counter() - t0:.2f} s")
    ctx_k = Context(mode=Mode.PFP, impl="kernel", device=device)
    ctx_e = Context(mode=Mode.PFP, impl="eager", device=device)
    frames = _audio_frames((LM_BATCH, LM_SEQ, cfg.d_model), 900, device)
    inputs = {"frame_embeddings": frames}

    # The forward: launches, kernel against eager, the uncertainty.
    reset_launch_counts()
    logits, _, _ = lm.forward(model, cfg, inputs, ctx_k)
    torch.cuda.synchronize()
    launches = {k: v for k, v in LAUNCHES.items() if v}
    want = {}
    for kernel, _ in audio_path_calls(cfg):
        want[kernel] = want.get(kernel, 0) + 1
    if launches != want:
        fail(f"audio forward launches {launches}, expected {want}")
    print(f"[audio] forward of {LM_BATCH} x {LM_SEQ} frames: launches "
          f"{launches} (each op of the path on its kernel)")
    eager, _, _ = lm.forward(model, cfg, inputs, ctx_e)
    fwd_errs, within = _model_errs("audio forward",
                                   (logits.mean, logits.var),
                                   (eager.mean, eager.var))
    if float(logits.var.min()) <= 0:
        fail("audio: non-positive logit variance")
    gen = torch.Generator(device=device).manual_seed(1)
    unc = metrics.pfp_predictive_metrics(gen, logits.mean[:, -1],
                                         logits.var[:, -1], 100)
    print(f"[audio] kernel vs eager logits: max abs err mean "
          f"{fwd_errs['mean']:.3e}, var {fwd_errs['var']:.3e}; within "
          f"MODEL_TOL: {within}; max |mean| "
          f"{float(eager.mean.abs().max()):.3e}, max var "
          f"{float(eager.var.max()):.3e}; next codes "
          f"{torch.argmax(logits.mean[:, -1], -1).tolist()}, MI "
          + ", ".join(f"{float(v):.4e}" for v in unc["mi"]))
    del logits, eager
    fwd = {"batch": LM_BATCH, "seq": LM_SEQ, "model": cfg.name}
    for impl, ctx, iters in (("kernel", ctx_k, 3), ("eager", ctx_e, 2)):
        fwd[f"{impl}_ms"] = time_ms(
            lambda c=ctx: lm.forward(model, cfg, inputs, c), iters=iters,
            warmup=1)
    fwd["kernel_graph_ms"] = device_ms(
        lambda: lm.forward(model, cfg, inputs, ctx_k), inner=1, replays=3)
    print(f"[times] forward {cfg.name} ({cfg.num_layers} layers) "
          f"B={LM_BATCH} T={LM_SEQ} kernel {fwd['kernel_ms']:.2f} ms  eager "
          f"{fwd['eager_ms']:.2f} ms  kernel in a CUDA graph "
          f"{fwd['kernel_graph_ms']:.2f} ms")
    profiles = {"forward": _profile(
        f"{cfg.name} B={LM_BATCH} T={LM_SEQ}",
        lambda: lm.forward(model, cfg, inputs, ctx_k), 2, 1)}

    # Prefill in chunks and decode on both pools, then the eager impl.
    prompts = [_audio_frames((n, cfg.d_model), 910 + i, device)
               for i, n in enumerate(AUDIO_PROMPTS)]
    steps = [_audio_frames((DECODE_SLOTS, 1, cfg.d_model), 950 + i, device)
             for i in range(AUDIO_STEPS)]
    runs, serve_launches = {}, {}
    for paged in (False, True):
        name = "paged" if paged else "contiguous"
        reset_launch_counts()
        t1 = time.perf_counter()
        runs[name] = _audio_serve(cfg, model, prompts, steps, device, paged)
        torch.cuda.synchronize()
        serve_launches[name] = {k: LAUNCHES[k] for k in AUDIO_DECODE_KERNELS}
        other = {k: v for k, v in LAUNCHES.items()
                 if v and k not in AUDIO_DECODE_KERNELS}
        missing = [k for k in AUDIO_DECODE_KERNELS
                   if serve_launches[name][k] == 0 and k != (
                       "attention_cache" if paged else "attention_paged")]
        if missing or other:
            fail(f"audio {name}: kernels never launched {missing}, "
                 f"off the path {other}")
        print(f"[audio] {name}: prompts {list(AUDIO_PROMPTS)} frames in "
              f"chunks of {PREFILL_CHUNK}, {AUDIO_STEPS} lockstep steps of "
              f"{DECODE_SLOTS} slots in {time.perf_counter() - t1:.2f} s; "
              f"prefill {np.mean(runs[name]['prefill_ms']):.2f} ms a prompt "
              f"(CUDA events), step {np.mean(runs[name]['step_ms']):.3f} ms "
              f"mean; launches {serve_launches[name]}")
    cont, paged = runs["contiguous"]["logits"], runs["paged"]["logits"]
    for i, (a, b) in enumerate(zip(cont, paged)):
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            fail(f"audio: pass {i}: paged logits differ from contiguous")
    print(f"[audio] paged and contiguous: every pass's logits bit for bit "
          f"({len(cont)} passes: {len(cont) - AUDIO_STEPS} chunks, "
          f"{AUDIO_STEPS} steps)")
    eager_run = _audio_serve(cfg, model, prompts, steps, device, False,
                             impl="eager")
    dec_errs = {"mean": 0.0, "var": 0.0}
    for i, (a, b) in enumerate(zip(cont, eager_run["logits"])):
        e, ok = _model_errs(f"audio pass {i}", a, b)
        if not all(ok.values()):
            fail(f"audio pass {i}: kernel vs eager logits outside "
                 f"MODEL_TOL: max abs err {e}")
        dec_errs = {k: max(dec_errs[k], e[k]) for k in e}
    out = uncertainty_decode(*cont[-1], gen)
    print(f"[audio] kernel vs eager, every chunk and step: max abs err mean "
          f"{dec_errs['mean']:.3e}, var {dec_errs['var']:.3e} (MODEL_TOL); "
          f"last step: codes {out.token.tolist()}, MI "
          + ", ".join(f"{float(v):.4e}" for v in out.mutual_info))
    serve_ms = {k: {"prefill_ms": v["prefill_ms"], "step_ms": v["step_ms"]}
                for k, v in runs.items()}
    del runs, eager_run, cont, paged

    # The whole-prompt prefill, a decode step's launches and profile.
    prefill_t = _Timer()
    prompt = {"frame_embeddings": prompts[0][None]}
    for _ in range(3):
        with prefill_t:
            last, _ = lm.prefill(model, cfg, prompt, ctx_k, DECODE_MAX_LEN)
    reset_launch_counts()
    last, _ = lm.prefill(model, cfg, prompt, ctx_k, DECODE_MAX_LEN)
    per_call = {"prefill": {k: v for k, v in LAUNCHES.items() if v}}
    want_last, _ = lm.prefill(model, cfg, prompt, ctx_e, DECODE_MAX_LEN)
    pre_errs, ok = _model_errs("audio prefill", (last.mean, last.var),
                               (want_last.mean, want_last.var))
    if not all(ok.values()):
        fail(f"audio prefill: kernel vs eager outside MODEL_TOL: {pre_errs}")
    pos = np.asarray([300, 400, 500, 540])
    step_inputs = {"frame_embeddings": steps[0], "positions": pos[:, None],
                   "cache_len": pos + 1}
    states = lm.init_decode_state(cfg, DECODE_SLOTS, DECODE_MAX_LEN,
                                  device=device)
    reset_launch_counts()
    lm.decode_step(model, cfg, step_inputs, states, ctx_k)
    per_call["decode_step"] = {k: v for k, v in LAUNCHES.items() if v}
    print(f"[audio] whole-prompt prefill of {AUDIO_PROMPTS[0]} frames: "
          f"{np.median(prefill_t.ms()):.2f} ms (median of 3, CUDA events), "
          f"kernel vs eager max abs err {pre_errs}; launches per prefill "
          f"{per_call['prefill']}; per contiguous decode step "
          f"{per_call['decode_step']}")
    profiles["decode_step"] = _profile(
        f"{cfg.name} decode step B={DECODE_SLOTS}",
        lambda: lm.decode_step(model, cfg, step_inputs, states, ctx_k), 5, 2)
    del states
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"[audio] peak max_memory_allocated {peak:.2f} GB (the model, "
          f"both pools in turn, the forwards)")

    # fp64 stage by stage (the gate where the logits missed MODEL_TOL).
    stages = _fp64_stage_check(cfg, model, frames, device,
                               all(within.values()))
    del model
    torch.cuda.empty_cache()

    # The kernels at the path's shapes.
    rows = []
    for kernel, shape in dict.fromkeys(audio_path_calls(cfg)):
        big = kernel == "dense"
        rows.append(_time_row("audio", kernel, shape, device,
                              inner=2 if big else 10, replays=2 if big else 5,
                              call_iters=3 if big else 30))
    for kernel, shape in dict.fromkeys(audio_path_calls(cfg, decode=True)):
        rows.append(_time_row("audio-decode", kernel, shape, device))
    for kernel in CACHE_KERNELS:
        paged_ps = (PAGE_SIZE,) if kernel == "attention_paged" else ()
        for label, shape in (("decode-audio", CACHE_DECODE_AUDIO),
                             ("chunk-audio", CACHE_CHUNK_AUDIO)):
            rows.append(_time_row(label, kernel, shape + paged_ps, device))
    info = {"forward_errors": fwd_errs, "forward_within_model_tol": within,
            "decode_errors": dec_errs, "prefill_errors": pre_errs,
            "fp64_stages": stages, "serve_ms": serve_ms,
            "prefill_ms": prefill_t.ms(), "serve_launches": serve_launches,
            "per_call_launches": per_call, "profiles": profiles,
            "peak_gb": peak, "forward": fwd}
    total = {k: serve_launches["contiguous"][k] + serve_launches["paged"][k]
             for k in AUDIO_DECODE_KERNELS}
    return ({"audio": launches, "audio_decode": total}, info, rows, fwd,
            profiles, cfg)


# ---------------------------------------------------------------------------
# The fused norm -> dense -> activation unit (row 8) and its schedule DB
# ---------------------------------------------------------------------------
def _ulps(a, b):
    """Largest distance between two fp32 tensors in units in the last
    place (0 when equal bit for bit; +0 and -0 count as equal)."""
    import torch

    def ordered(t):
        i = t.contiguous().view(torch.int32).long()
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int((ordered(a) - ordered(b)).abs().max())


def fused_kernel_checks(device, errs):
    """The fused kernel against its plain version at FUSED_CHECK_SHAPES for
    every norm, rep, activation and tile, and against the unfused kernel
    chain (bitwise count); then at the path's gate and decode shapes,
    every tile against the plain version (DENSE_TOL) and the chain (bit
    for bit, or the largest ulp gap within NDA_TOL). Updates ``errs``;
    returns the path shapes' comparisons."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.pfp_activations import KINDS
    from repro_torch.kernels.pfp_fused import TILES
    from repro_torch.tuning.measure import unfused_chain
    from repro_torch.tuning.schedules import Schedule
    scheds = [Schedule.make("norm_dense_act", block_m=bm, block_n=bn)
              for bm, bn in TILES]
    for shape in FUSED_CHECK_SHAPES:
        m, k, n = shape
        mu, var = gaussian((m, k), sum(shape), device)
        g = torch.Generator(device="cpu").manual_seed(sum(shape) + 1)
        gain, bias = (1.0 + 0.1 * torch.randn((2, k), generator=g)).to(device)
        bias = bias - 1.0
        mw, vw = gaussian((k, n), sum(shape) + 2, device, 0.1)
        srm_w = vw + mw * mw
        for norm in ("rmsnorm", "layernorm"):
            for rep in ("var", "srm"):
                second = var if rep == "var" else var + mu * mu
                b = bias if norm == "layernorm" else None
                worst, bitwise, runs = 0.0, 0, 0
                for act in KINDS:
                    kw = dict(norm=norm, rep=rep, act=act)
                    want = ref.pfp_norm_dense_act_ref(mu, second, gain, b, mw,
                                                      srm_w, **kw)
                    chain = unfused_chain(mu, second, gain, b, mw, srm_w,
                                          **kw)
                    for sched in scheds:
                        got = ops.pfp_norm_dense_act(mu, second, gain, b, mw,
                                                     srm_w, schedule=sched,
                                                     **kw)
                        torch.cuda.synchronize()
                        label = (f"norm_dense_act{shape} {norm} {rep} {act} "
                                 f"{sched.describe()}")
                        _check_close(label, got, want, DENSE_TOL)
                        worst = max(worst, _max_err(got, want))
                        bitwise += all(torch.equal(x, y)
                                       for x, y in zip(got, chain))
                        runs += 1
                errs["norm_dense_act"] = max(errs["norm_dense_act"], worst)
                print(f"[fused] kernel {str(shape):16s} {norm:9s} rep={rep}:"
                      f" 5 activations x {len(scheds)} tiles, max_abs_err vs "
                      f"plain {worst:.3e}; bit for bit the unfused kernel "
                      f"chain in {bitwise} of {runs}")
    # The path's two shapes: the gate projection at 4 x 512 tokens and at a
    # decode step. Every tile against the plain version on the same
    # operands, and against the unfused kernel chain bit for bit (or the
    # largest ulp gap, within NDA_TOL).
    cfg = lm_config()
    path = {}
    for label, shape in (
            ("gate", (LM_BATCH * LM_SEQ, cfg.d_model, cfg.d_ff)),
            ("decode", (DECODE_SLOTS, cfg.d_model, cfg.d_ff))):
        args = operands("norm_dense_act", shape, 1600, device)
        want = run_plain("norm_dense_act", args)
        chain = unfused_chain(*args[:6])
        for sched in scheds:
            got = run_kernel("norm_dense_act", (*args[:6], sched))
            torch.cuda.synchronize()
            name = f"norm_dense_act{shape} {sched.describe()}"
            _check_close(name, got, want, DENSE_TOL)
            err = _max_err(got, want)
            errs["norm_dense_act"] = max(errs["norm_dense_act"], err)
            ulps = max(_ulps(x, y) for x, y in zip(got, chain))
            diff = _max_err(got, chain)
            close = all(torch.allclose(x, y, **NDA_TOL)
                        for x, y in zip(got, chain))
            path[f"{label} {sched.describe()}"] = {
                "shape": shape, "max_abs_err_vs_plain": err,
                "bitwise": ulps == 0, "max_ulps": ulps,
                "max_abs_diff": diff}
            verdict = ("bit for bit" if ulps == 0 else
                       f"{ulps} ulps (max abs diff {diff:.3e}) from")
            print(f"[fused] {label} {shape} {sched.describe()}: max_abs_err "
                  f"vs plain {err:.3e}; {verdict} the unfused kernel chain")
            if not close:
                fail(f"fused {label} {sched.describe()}: outside NDA_TOL of "
                     f"the unfused chain, max abs diff {diff:.3e}")
        del args, want, chain, got
    return path


def phase_fused(device, seed, errs):
    """Row 8 on granite-8b's path: kernel checks, the autotuner on the card,
    the fused forward and decode against the unfused ones, and times."""
    import numpy as np
    import torch
    from repro_torch.core import dispatch
    from repro_torch.core.modes import Mode
    from repro_torch.kernels._launch import LAUNCHES, reset_launch_counts
    from repro_torch.models import lm
    from repro_torch.nn.module import Context
    from repro_torch.tuning import autotune
    from repro_torch.tuning import cache as tcache
    from repro_torch.tuning.measure import unfused_chain

    info = {"path_shapes": fused_kernel_checks(device, errs)}

    # Autotune on the card, save under build/, reload.
    tcache.reset_global_cache()
    if SCHEDULE_DB.exists():
        SCHEDULE_DB.unlink()
    t0 = time.perf_counter()
    chosen = autotune.main([
        "--config", LM_ARCH, "--layers", str(LM_LAYERS),
        "--fuse", "--batch", str(LM_BATCH), "--seq", str(LM_SEQ),
        "--decode-slots", str(DECODE_SLOTS), "--limit", "4",
        "--save", str(SCHEDULE_DB)])
    torch.cuda.empty_cache()
    tuned = tcache.global_cache().entries()
    tcache.reset_global_cache()
    db = tcache.load_global_cache(str(SCHEDULE_DB))
    if db.entries() != tuned or len(db) != 2 or len(chosen) != 2:
        fail(f"fused: the reloaded DB {db.entries()} is not the tuned one "
             f"{tuned} ({len(chosen)} queries)")
    backend = tcache.default_backend(device)
    info["schedules"] = {}
    fuses = {}
    for (op, key, dtype, _), sched in chosen.items():
        meta = db.get_meta(op, key, dtype, backend)
        info["schedules"][str(key)] = {"schedule": sched.describe(), **meta}
        fuses[tuple(key)] = meta["fuse"]
        if meta["mode"] != "time" or meta["dropped"]:
            fail(f"fused: {key} was not timed on the card, or candidates "
                 f"failed the check against the unfused chain: {meta}")
        print(f"[fused] DB {key}: {sched.describe()} at "
              f"{meta['measured_s'] * 1e3:.4f} ms against the unfused "
              f"chain's {meta['unfused_s'] * 1e3:.4f} ms (median CUDA-event "
              f"times; candidates {meta['candidates']}): "
              + ("fuse" if meta["fuse"] else "stay unfused"))
    print(f"[fused] autotune + save + reload in "
          f"{time.perf_counter() - t0:.1f} s -> "
          f"{SCHEDULE_DB.relative_to(ROOT)}")
    gate_key = (LM_BATCH * LM_SEQ, lm_config().d_model, lm_config().d_ff)
    step_key = (DECODE_SLOTS, lm_config().d_model, lm_config().d_ff)
    info["tuned_fuses"] = {"forward": fuses[gate_key],
                           "decode": fuses[step_key]}
    print(f"[fused] the tuned DB fuses: forward "
          f"{'yes' if fuses[gate_key] else 'no'}, decode step "
          f"{'yes' if fuses[step_key] else 'no'}")

    # A copy of the tuned DB with every entry set to fuse, so that the
    # fusion pass runs the fused kernel inside the model whatever the tuner
    # chose. The forward and the decode run with each DB.
    payload = json.loads(SCHEDULE_DB.read_text())
    for entry in payload["entries"].values():
        entry["meta"]["fuse"] = True
    FORCED_DB.write_text(json.dumps(payload, indent=2, sort_keys=True))
    dbs = {"tuned": (SCHEDULE_DB, fuses),
           "forced": (FORCED_DB, dict.fromkeys(fuses, True))}

    def use_db(label):
        tcache.reset_global_cache()
        tcache.load_global_cache(str(dbs[label][0]))

    # The fused forward against the unfused one.
    cfg, model = _lm_model(device)
    tokens = _lm_requests(cfg, device)[0]
    ctx = Context(mode=Mode.PFP, impl="kernel", device=device)
    kinds = ("norm_dense_act", "activation", "dense", "rmsnorm")
    per_forward = {}
    for kernel, _ in lm_path_calls(cfg):
        per_forward[kernel] = per_forward.get(kernel, 0) + 1
    want_unfused = {k: per_forward.get(k, 0) for k in kinds}
    reset_launch_counts()
    base, _, _ = lm.forward(model, cfg, {"tokens": tokens}, ctx)
    launches = {"unfused": {k: LAUNCHES[k] for k in kinds}}
    if launches["unfused"] != want_unfused:
        fail(f"unfused forward launches {launches['unfused']}, expected "
             f"{want_unfused}")
    info["forward"] = {}
    for db in dbs:
        use_db(db)
        # The gate's unit runs fused only where the DB says fuse.
        gate_fuses = dbs[db][1][(LM_BATCH * LM_SEQ, cfg.d_model, cfg.d_ff)]
        fused_units = cfg.num_layers if gate_fuses else 0
        want_fused = dict(want_unfused, norm_dense_act=fused_units,
                          activation=want_unfused["activation"] - fused_units,
                          dense=want_unfused["dense"] - fused_units)
        label = FUSED_RUNS[db]
        reset_launch_counts()
        tcache.consult_counters(reset=True)
        with dispatch.fusion(True):
            fused, _, _ = lm.forward(model, cfg, {"tokens": tokens}, ctx)
        torch.cuda.synchronize()
        launches[label] = {k: LAUNCHES[k] for k in kinds}
        consults = tcache.consult_counters()
        print(f"[fused] forward {LM_BATCH} x {LM_SEQ}, {db} DB: launches "
              f"{launches[label]} (norm_dense_act "
              f"{launches[label]['norm_dense_act']}), unfused "
              f"{launches['unfused']}; cache consults {consults}")
        if launches[label] != want_fused:
            fail(f"fused forward ({db} DB) launches {launches[label]}, "
                 f"expected {want_fused}")
        if consults["consults"] != cfg.num_layers or \
                consults["hits"] != fused_units:
            fail(f"fused forward ({db} DB): cache consults {consults}, "
                 f"expected {cfg.num_layers} consults and {fused_units} hits "
                 f"(the DB says {'fuse' if gate_fuses else 'stay unfused'} "
                 f"at the gate)")
        greedy = bool(torch.equal(fused.mean.argmax(-1),
                                  base.mean.argmax(-1)))
        errs_fwd = {}
        for part in ("mean", "var"):
            got, want = getattr(fused, part), getattr(base, part)
            errs_fwd[part] = float((got - want).abs().max())
            if not torch.isfinite(got).all() or \
                    not torch.allclose(got, want, **NDA_TOL):
                fail(f"fused forward ({db} DB) {part}: max abs diff "
                     f"{errs_fwd[part]:.3e} outside NDA_TOL of the unfused "
                     f"forward")
        bitwise = torch.equal(fused.mean, base.mean) and \
            torch.equal(fused.var, base.var)
        print(f"[fused] forward, {db} DB: greedy tokens "
              f"{'equal' if greedy else 'DIFFER'} at all {LM_BATCH} x "
              f"{LM_SEQ} positions; logits max abs diff mean "
              f"{errs_fwd['mean']:.3e}, var {errs_fwd['var']:.3e}"
              f"{' (bit for bit)' if bitwise else ''}")
        if not greedy:
            fail(f"fused forward ({db} DB): greedy tokens differ from the "
                 f"unfused forward")
        info["forward"][db] = {"launches": launches[label],
                               "consults": consults, "greedy_equal": greedy,
                               "bitwise": bitwise, "max_abs_diff": errs_fwd}
        del fused
    del base
    times = {}
    for label, on, db in (("unfused", False, "tuned"),
                          ("fused", True, "tuned"),
                          ("fused_forced", True, "forced")):
        use_db(db)
        with dispatch.fusion(on):
            fwd = lambda: lm.forward(model, cfg, {"tokens": tokens},  # noqa
                                     ctx)
            times[f"{label}_ms"] = time_ms(fwd, iters=3, warmup=1)
            times[f"{label}_graph_ms"] = device_ms(fwd, inner=1, replays=3)
    info["forward"]["times"] = times
    print(f"[times] forward {cfg.name} ({cfg.num_layers} layers) B={LM_BATCH}"
          f" T={LM_SEQ} fused by the tuned DB {times['fused_ms']:.2f} ms "
          f"(CUDA graph {times['fused_graph_ms']:.2f}), fused at every unit "
          f"{times['fused_forced_ms']:.2f} ms (CUDA graph "
          f"{times['fused_forced_graph_ms']:.2f}), unfused "
          f"{times['unfused_ms']:.2f} ms (CUDA graph "
          f"{times['unfused_graph_ms']:.2f})")

    # Decode through DecodeStatePool: unfused, then fused with each DB.
    requests = _decode_requests(cfg, seed)
    runs = {}
    for label, on, db in (("unfused", False, "tuned"),
                          ("fused", True, "tuned"),
                          ("fused_forced", True, "forced")):
        use_db(db)
        reset_launch_counts()
        tcache.consult_counters(reset=True)
        with dispatch.fusion(on):
            run = _serve(cfg, model, requests, device, False, seed)
        torch.cuda.synchronize()
        run["launches"] = {k: LAUNCHES[k] for k in kinds}
        run["consults"] = tcache.consult_counters()
        runs[label] = run
        print(f"[fused] decode {label}: {run['steps']} lockstep steps, step "
              f"{np.mean(run['step_ms']):.3f} ms mean, prefill "
              f"{np.mean(run['prefill_ms']):.2f} ms per prompt; launches "
              f"{run['launches']}; cache consults {run['consults']}")
    info["decode"] = {}
    for db, label in FUSED_RUNS.items():
        run = runs[label]
        for a, b in zip(runs["unfused"]["finished"], run["finished"]):
            if a.generated != b.generated:
                fail(f"fused decode ({db} DB) uid {a.uid}: tokens "
                     f"{b.generated} != unfused {a.generated}")
        # The decode step's unit runs fused only where the DB says fuse;
        # each cache hit launches the fused kernel once.
        step_fuses = dbs[db][1][(DECODE_SLOTS, cfg.d_model, cfg.d_ff)]
        fused_launches = run["launches"]["norm_dense_act"]
        if len(run["finished"]) != DECODE_REQUESTS or \
                (fused_launches > 0) != step_fuses or \
                fused_launches != run["consults"]["hits"]:
            fail(f"fused decode ({db} DB): {len(run['finished'])} of "
                 f"{DECODE_REQUESTS} requests finished; the fused kernel "
                 f"launched {fused_launches} times on "
                 f"{run['consults']['hits']} cache hits where the DB says "
                 f"{'fuse' if step_fuses else 'stay unfused'}")
        same_logits = all(torch.equal(a, b) for a, b in zip(
            runs["unfused"]["last_logits"], run["last_logits"]))
        print(f"[fused] decode, {db} DB: all {DECODE_REQUESTS} requests give "
              f"the unfused run's tokens; last-step logits "
              f"{'bit for bit equal' if same_logits else 'differ in bits'}")
        launches[f"{label}_decode"] = run["launches"]
        info["decode"][f"{db}_last_logits_bitwise"] = same_logits
    for label, run in runs.items():
        info["decode"][label] = {k: run[k] for k in (
            "steps", "step_ms", "prefill_ms", "launches", "consults")}
    use_db("tuned")

    # One 4-slot decode step's device time, unfused and fused by the tuned
    # DB (stale cache rows: only the time is read).
    pos = np.asarray([300, 400, 500, 540])
    step_inputs = {"tokens": np.ones((DECODE_SLOTS, 1), np.int64),
                   "positions": pos[:, None], "cache_len": pos + 1}
    states = lm.init_decode_state(cfg, DECODE_SLOTS, DECODE_MAX_LEN,
                                  device=device)
    info["decode"]["step_busy_ms"] = {}
    for label, on in (("unfused", False), ("fused", True)):
        with dispatch.fusion(on):
            row = _profile(f"{cfg.name} decode step B={DECODE_SLOTS}, "
                           f"{label}", lambda: lm.decode_step(
                               model, cfg, step_inputs, states, ctx), 5, 2)
        info["decode"]["step_busy_ms"][label] = (
            None if row is None else row["busy_ms"])
    del states

    # Row 8 at the gate and decode shapes, beside the unfused chain.
    rows = []
    m = LM_BATCH * LM_SEQ
    for shape in ((m, cfg.d_model, cfg.d_ff),
                  (DECODE_SLOTS, cfg.d_model, cfg.d_ff)):
        big = shape[0] > 100
        row = _time_row("fused", "norm_dense_act", shape, device,
                        inner=2 if big else 10, replays=2 if big else 5,
                        call_iters=3 if big else 30)
        args = operands("norm_dense_act", shape, 1, device)
        row["schedule"] = None if args[6] is None else args[6].describe()
        h_mu, h_var = run_kernel("rmsnorm", args[:3])
        h_srm = h_var + torch.square(h_mu)
        y = run_kernel("dense", (h_mu, h_srm, *args[4:6]))
        kw = dict(inner=2 if big else 10, replays=2 if big else 5)
        row["unfused_kernels_ms"] = {
            "rmsnorm": device_ms(lambda: run_kernel("rmsnorm", args[:3]),
                                 **kw),
            "dense": device_ms(lambda: run_kernel(
                "dense", (h_mu, h_srm, *args[4:6])), **kw),
            "activation": device_ms(lambda: run_kernel(
                "activation", (*y, "silu")), **kw)}
        row["unfused_chain_ms"] = device_ms(
            lambda: unfused_chain(*args[:6]), **kw)
        print(f"[times] row 8 {str(shape):20s} {row['schedule']}: fused "
              f"{row['ms']:.4f} ms; unfused kernels "
              + " + ".join(f"{k} {v:.4f}"
                           for k, v in row["unfused_kernels_ms"].items())
              + f" = {sum(row['unfused_kernels_ms'].values()):.4f} ms; "
              f"unfused chain with to_srm {row['unfused_chain_ms']:.4f} ms")
        rows.append(row)
        del args, h_mu, h_var, h_srm, y
    del model
    tcache.reset_global_cache()
    return launches, info, rows


# ---------------------------------------------------------------------------
# Training: the paper's Table-1 pipeline end to end, granite-8b's SVI steps
# ---------------------------------------------------------------------------
def _event_ms(pairs):
    """Elapsed ms of each (start, end) CUDA event pair (after a sync)."""
    return [a.elapsed_time(b) for a, b in pairs]


def _svi_train(name, model, view, x_train, y_train, device):
    """SVI-train ``model`` as the reference's trained_paper_models does:
    Adam 3e-3, KLSchedule(0.25, 150), batches of TRAIN_BATCH for
    TRAIN_EPOCHS epochs (the port's ``batches``, on the card), every eps
    from one seeded CUDA generator. Returns a dict of what it printed."""
    import numpy as np
    import torch
    from repro_torch.bayes.variational import KLSchedule
    from repro_torch.data.dirty_mnist import batches
    from repro_torch.training.optimizer import Adam
    from repro_torch.training.train_loop import (init_train_state,
                                                 make_svi_train_step)
    opt = Adam(learning_rate=3e-3)
    step = make_svi_train_step(
        lambda m, batch, ctx: (m(view(batch["x"]), ctx), 0.0), opt,
        num_data=TRAIN_N, kl_schedule=KLSchedule(0.25, 150))
    state = init_train_state(model, opt)
    order = torch.from_numpy(np.stack([
        i for i, _ in batches(np.arange(len(x_train)), None, TRAIN_BATCH,
                              epochs=TRAIN_EPOCHS)])).to(device)
    gen = torch.Generator(device=device).manual_seed(7)
    events, nll = [], []
    t0 = time.perf_counter()
    for rows in order:
        pair = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        pair[0].record()
        state, metrics = step(state, {"x": x_train[rows],
                                      "targets": y_train[rows]}, gen)
        pair[1].record()
        events.append(pair)
        nll.append(metrics["nll"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ms = _event_ms(events)
    nll = torch.stack(nll).cpu()
    last = {k: float(v) for k, v in metrics.items()}
    if not all(np.isfinite(list(last.values()))) or \
            not torch.isfinite(nll).all():
        fail(f"{name}: non-finite training metrics {last}")
    info = {"steps": state.step, "step_ms_median": float(np.median(ms)),
            "step_ms_p90": float(np.percentile(ms, 90)), "wall_s": wall,
            "first_nll": float(nll[0]), "last_nll": float(nll[-1]),
            "last": last}
    print(f"[train] {name}: {state.step} SVI steps in {wall:.2f} s; step "
          f"{info['step_ms_median']:.4f} ms median, "
          f"{info['step_ms_p90']:.4f} p90 (eager, CUDA events); NLL "
          f"{info['first_nll']:.4f} -> {info['last_nll']:.4f}, final KL "
          f"{last['kl']:.4f} (per datum), loss {last['loss']:.4f}, "
          f"grad norm {last['grad_norm']:.4f}")
    if not info["last_nll"] < 0.5 * info["first_nll"]:
        fail(f"{name}: the NLL did not halve ({info['first_nll']:.4f} -> "
             f"{info['last_nll']:.4f})")
    return info


def _table1(name, model, view, evals, device):
    """Table 1 on the trained ``model``: DET accuracy, SVI-30 accuracy and
    MI-AUROC (OOD vs clean), PFP through the kernels with the calibration
    factor searched by MI-AUROC (Eq. 11, TABLE1_SAMPLES samples), and the
    calibrated kernel logits held against the eager impl under both
    formulations and an fp64 forward. Runs under no_grad."""
    import copy

    import numpy as np
    import torch
    from repro_torch.bayes import metrics as bm
    from repro_torch.bayes.convert import fit_calibration_factor, svi_to_pfp
    from repro_torch.core.modes import Mode
    from repro_torch.nn.module import Context
    xc, yc = (torch.from_numpy(a).to(device) for a in evals["clean"])
    xo = torch.from_numpy(evals["ood"][0]).to(device)
    xc, xo, yc = view(xc), view(xo), yc.cpu().numpy()

    det = model(xc, Context(mode=Mode.DETERMINISTIC, device=device))
    det_acc = bm.accuracy(det.argmax(-1), yc)
    svi = Context(mode=Mode.SVI, device=device,
                  generator=torch.Generator(device=device).manual_seed(100))
    svi_c = bm.predictive_metrics_from_samples(torch.stack(
        [model(xc, svi) for _ in range(TABLE1_SAMPLES)]))
    svi_o = bm.predictive_metrics_from_samples(torch.stack(
        [model(xo, svi) for _ in range(TABLE1_SAMPLES)]))
    svi_acc = bm.accuracy(svi_c["pred"], yc)
    svi_auroc = bm.auroc(svi_o["mi"], svi_c["mi"])

    pfp = {}

    def eval_cal(cal):
        converted = svi_to_pfp(model, calibration_factor=cal)
        ctx = Context(mode=Mode.PFP, impl="kernel", device=device)
        oc, oo = converted(xc, ctx), converted(xo, ctx)
        mc = bm.pfp_predictive_metrics(
            torch.Generator(device=device).manual_seed(5), oc.mean, oc.var,
            TABLE1_SAMPLES)
        mo = bm.pfp_predictive_metrics(
            torch.Generator(device=device).manual_seed(6), oo.mean, oo.var,
            TABLE1_SAMPLES)
        pfp[cal] = (converted, bm.accuracy(mc["pred"], yc),
                    bm.auroc(mo["mi"], mc["mi"]))
        return pfp[cal][2]

    cal, pfp_auroc = fit_calibration_factor(eval_cal,
                                            candidates=TABLE1_CANDIDATES)
    converted, pfp_acc, _ = pfp[cal]
    # The kernel impl against the eager impl, both in fp32, and both
    # against the eager impl in fp64 on the same converted weights. On the
    # trained LeNet-5 both fp32 impls sit about 1e-3 from the fp64 logits
    # (Clark's max of nearly equal, nearly certain inputs cancels), ten
    # times MODEL_TOL's atol, so two right impls may differ by more than
    # MODEL_TOL there: the gate is that the kernel impl is no further from
    # fp64 than FP64_FACTOR times the eager impl, and MODEL_TOL is printed.
    exact = copy.deepcopy(converted).double()
    errs = {}
    for formulation in ("srm", "var"):
        outs = {impl: converted(xc, Context(
            mode=Mode.PFP, impl=impl, formulation=formulation, device=device))
            for impl in ("kernel", "eager")}
        ref = exact(xc.double(), Context(
            mode=Mode.PFP, impl="eager", formulation=formulation,
            device=device))
        for part in ("mean", "var"):
            got, want, ref64 = (getattr(o, part)
                                for o in (outs["kernel"], outs["eager"], ref))
            if tuple(got.shape) != (EVAL_N, 10) or \
                    not torch.isfinite(got).all():
                fail(f"{name}/{formulation} {part}: bad trained logits")
            rtol, atol = MODEL_TOL[part]
            e = {"kernel_vs_eager": float((got - want).abs().max()),
                 "kernel_vs_fp64": float((got.double() - ref64).abs().max()),
                 "eager_vs_fp64": float((want.double() - ref64).abs().max()),
                 "outside_model_tol": int((~torch.isclose(
                     got, want, rtol=rtol, atol=atol)).sum())}
            errs[f"{formulation}_{part}"] = e
            if e["kernel_vs_fp64"] > FP64_FACTOR * e["eager_vs_fp64"]:
                fail(f"{name}/{formulation} {part}, trained weights: the "
                     f"kernel impl is {e['kernel_vs_fp64']:.3e} from fp64, "
                     f"the eager impl {e['eager_vs_fp64']:.3e}")
        if float(outs["kernel"].var.min()) <= 0:
            fail(f"{name}/{formulation}: non-positive logit variance")
    info = {"det_acc": det_acc, "svi_acc": svi_acc, "svi_auroc": svi_auroc,
            "pfp_acc": pfp_acc, "pfp_auroc": pfp_auroc, "cal": cal,
            "auroc_by_cal": {str(c): v[2] for c, v in pfp.items()},
            "kernel_vs_eager": errs}
    print(f"[train] {name} Table 1: DET acc {det_acc:.4f}; SVI-"
          f"{TABLE1_SAMPLES} acc {svi_acc:.4f} MI-AUROC {svi_auroc:.4f}; PFP "
          f"(kernel impl, cal {cal}) acc {pfp_acc:.4f} MI-AUROC "
          f"{pfp_auroc:.4f}; |SVI - PFP| acc {abs(svi_acc - pfp_acc):.4f}")
    print(f"[train] {name}: MI-AUROC by factor " + ", ".join(
        f"{c} {v[2]:.4f}" for c, v in pfp.items()))
    for k, e in errs.items():
        print(f"[train] {name} {k} logits, max abs err: kernel vs fp64 "
              f"{e['kernel_vs_fp64']:.3e}, eager vs fp64 "
              f"{e['eager_vs_fp64']:.3e}, kernel vs eager "
              f"{e['kernel_vs_eager']:.3e} ({e['outside_model_tol']} of "
              f"{EVAL_N * 10} outside MODEL_TOL)")
    if not det_acc > 0.6:
        fail(f"{name}: DET accuracy {det_acc:.4f} not above 0.6")
    if not abs(svi_acc - pfp_acc) < 0.08:
        fail(f"{name}: |SVI - PFP| accuracy {abs(svi_acc - pfp_acc):.4f}")
    if not pfp_auroc > 0.6:
        fail(f"{name}: PFP MI-AUROC {pfp_auroc:.4f} not above 0.6")
    return info


def _lm_train(device):
    """LM_TRAIN_STEPS SVI train steps of granite-8b (lm_config: full width,
    LM_LAYERS layers) on TokenPipeline batches of 1 x LM_TRAIN_SEQ tokens.
    Step 1 runs twice from the same state and generator seed (the
    parameters restored, the moments zeroed): the two losses must be
    equal, every parameter must have changed after it, and every loss and
    gradient norm must be finite."""
    import numpy as np
    import torch
    from repro_torch.bayes.variational import KLSchedule
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.models import lm
    from repro_torch.training.optimizer import Adam
    from repro_torch.training.train_loop import (init_train_state,
                                                 make_svi_train_step)
    cfg = lm_config()
    model = lm.init_params(
        cfg, generator=torch.Generator(device=device).manual_seed(0),
        device=device)
    n_params = sum(p.numel() for p in model.parameters())
    opt = Adam(learning_rate=1e-3, clip_norm=1.0)

    def forward(m, batch, ctx):
        logits, aux, _ = lm.forward(m, cfg, batch, ctx)
        return logits, aux

    step = make_svi_train_step(
        forward, opt, num_data=LM_TRAIN_SEQ * 1000,
        kl_schedule=KLSchedule(0.25, 1000))
    pipe = TokenPipeline(cfg.vocab_size, LM_TRAIN_SEQ, 1)
    data = [{k: torch.from_numpy(v).long().to(device)
             for k, v in pipe.batch(i).items()}
            for i in range(LM_TRAIN_STEPS)]

    def timed(state, i):
        gen = torch.Generator(device=device).manual_seed(1000 + i)
        pair = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        pair[0].record()
        state, metrics = step(state, data[i], gen)
        pair[1].record()
        torch.cuda.synchronize()
        metrics = {k: float(v) for k, v in metrics.items()}
        if not all(np.isfinite(list(metrics.values()))):
            fail(f"{cfg.name} step {i + 1}: non-finite metrics {metrics}")
        ms = _event_ms([pair])[0]
        print(f"[train] {cfg.name} ({cfg.num_layers} layers) step {i + 1}: "
              f"{ms:.2f} ms; loss {metrics['loss']:.4f} nll "
              f"{metrics['nll']:.4f} kl {metrics['kl']:.4f} grad norm "
              f"{metrics['grad_norm']:.4f}")
        return state, metrics, ms

    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(model, opt)
    before = [p.detach().clone() for p in model.parameters()]
    state, first, first_ms = timed(state, 0)
    unchanged = [n for (n, p), b in zip(model.named_parameters(), before)
                 if torch.equal(p, b)]
    if unchanged:
        fail(f"{cfg.name}: parameters unchanged by step 1: {unchanged}")
    with torch.no_grad():
        for p, b in zip(model.parameters(), before):
            p.copy_(b)
    del before, state
    state = init_train_state(model, opt)
    state, again, again_ms = timed(state, 0)
    if again["loss"] != first["loss"]:
        fail(f"{cfg.name}: step 1 from the same state and seed gave loss "
             f"{again['loss']!r}, first {first['loss']!r}")
    steps = [again_ms]
    for i in range(1, LM_TRAIN_STEPS):
        state, _, ms = timed(state, i)
        steps.append(ms)
    peak = torch.cuda.max_memory_allocated()
    print(f"[train] {cfg.name}: {n_params / 1e9:.3f} G parameters (mu, rho "
          f"and norm gains), all changed by step 1; step 1 again from the "
          f"same state and seed: loss equal ({again['loss']!r}); step ms "
          f"{', '.join(f'{t:.2f}' for t in steps)} (the first run of step 1, "
          f"first calls included: {first_ms:.2f}); peak "
          f"max_memory_allocated {peak / 1e9:.2f} GB")
    return {"params": n_params, "step_ms": steps, "first_call_ms": first_ms,
            "repeat_loss": again["loss"], "first": first, "peak_bytes": peak}


def phase_train(device):
    """SVI-train the MLP and LeNet-5 on Dirty-MNIST, evaluate Table 1 with
    the PFP forward on the kernels (rows 1-4 on trained weights), then
    granite-8b's SVI train steps. Returns (launches of the Table-1 PFP
    forwards, info)."""
    import torch
    from repro_torch.data.dirty_mnist import dirty_mnist
    from repro_torch.kernels._launch import LAUNCHES, reset_launch_counts
    from repro_torch.models.simple import MLP, LeNet5
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        fail("TF32 is on; SVI training must run IEEE fp32 (cuDNN's conv "
             "backward included)")
    (x_train, y_train), evals = dirty_mnist(n_train=TRAIN_N, n_eval=EVAL_N)
    x_train = torch.from_numpy(x_train).to(device)
    y_train = torch.from_numpy(y_train).to(device)
    specs = {   # trained_paper_models(quick=False): name, init seed, input
        "mlp": (MLP(d_hidden=100, sigma_init=1e-3, device=device,
                    generator=torch.Generator().manual_seed(0)),
                lambda x: x.reshape(len(x), -1)),
        "lenet5": (LeNet5(sigma_init=1e-3, device=device,
                          generator=torch.Generator().manual_seed(1)),
                   lambda x: x[..., None]),
    }
    info = {}
    reset_launch_counts()
    for name, (model, view) in specs.items():
        info[name] = _svi_train(name, model, view, x_train, y_train, device)
    if any(LAUNCHES.values()):
        fail(f"SVI training launched PFP kernels: {LAUNCHES}")
    reset_launch_counts()
    with torch.no_grad():
        for name, (model, view) in specs.items():
            info[name]["table1"] = _table1(name, model, view, evals, device)
    launches = {k: LAUNCHES[k] for k in CNN_KERNELS}
    print(f"[train] Table-1 PFP forwards on trained weights: launches "
          f"{launches}")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        fail(f"kernels never launched on trained weights: {missing}")
    del specs, x_train, y_train
    torch.cuda.empty_cache()
    reset_launch_counts()
    info["lm"] = _lm_train(device)
    if any(LAUNCHES.values()):
        fail(f"LM SVI training launched PFP kernels: {LAUNCHES}")
    torch.cuda.empty_cache()
    return launches, info


def moe_path_calls(cfg, shapes):
    """The batched expert kernel's calls in one MoE forward or decode step:
    up, gate and down per MoE layer; ``shapes`` is (up, down)."""
    moe_layers = sum(cfg.layer_kind(i) == "moe" for i in range(cfg.num_layers))
    return [shapes[0], shapes[0], shapes[1]] * moe_layers


def kernel_summary(rows, launches, errs, lm_cfg, moe_cfg, audio_cfg):
    """Per kernel: for the CNN path's kernels, its calls at batch 100,
    times and bounds summed over one LeNet-5 and one MLP forward (Eq. 12
    forwards; Eq. 7 for dense_var), with one LM forward's dense calls
    beside (for dense_var in Eq. 7); for the LM's norm, GLU and attention,
    its calls in one LM forward (layernorm: one musicgen-medium forward's
    calls; rmsnorm with one granite and one deepseek decode step's calls
    beside); beside, for the dense, activation, layernorm and attention
    kernels, one musicgen-medium forward's calls and (but attention) one
    of its decode steps'; for the cache kernels, their calls in one decode
    step at CACHE_DECODE, with one deepseek-moe-16b decode step's calls
    (CACHE_DECODE_MOE), one musicgen-medium decode step's
    (CACHE_DECODE_AUDIO), one call at CACHE_PREFILL and one at
    CACHE_CHUNK_AUDIO beside; for the
    batched expert kernels, their calls in one MoE forward of 4 x 512
    tokens (dense_batched_first_layer, on no path: one call at the expert
    up shape), with one MoE decode step's calls beside; for the fused
    unit, its calls in one fused granite forward (gate shape), with one
    fused decode step's calls beside. ``launches`` sums the paths' runs."""
    cnn = {(r["kernel"], tuple(r["shape"])): r for r in rows
           if r["batch"] == MAIN_BATCH}
    lmr = {(r["kernel"], tuple(r["shape"])): r for r in rows
           if r["batch"] == "lm"}
    cache = {(r["kernel"], r["batch"]): r for r in rows
             if r["kernel"] in CACHE_KERNELS}
    moer = {(r["kernel"], tuple(r["shape"])): r for r in rows
            if r["batch"] == "moe"}
    occ = {(r["kernel"], tuple(r["shape"])): r for r in rows
           if r["batch"] == "moe-occ"}
    dec = {tuple(r["shape"]): r for r in rows
           if r["batch"] == "lm-decode" and r["kernel"] == "dense"}
    normdec = {(r["batch"], tuple(r["shape"])): r for r in rows
               if r["kernel"] == "rmsnorm"
               and r["batch"] in ("lm-decode", "moe-decode")}
    chunk = {tuple(r["shape"]): r for r in rows if r["batch"] == "lm-chunk"}
    fused = {tuple(r["shape"]): r for r in rows if r["batch"] == "fused"}
    aud = {(r["kernel"], tuple(r["shape"])): r for r in rows
           if r["batch"] in ("audio", "audio-decode")}

    def per_call(r):
        return {k: r[k] for k in ("shape", "ms", "plain_ms", "library_ms",
                                  "bound_ms", "bound_by")}

    def summed(kernel, calls):
        """Times, library time and bound summed over ``calls``."""
        lib = [r["library_ms"] for r in calls]
        out = {"ms": sum(r["ms"] for r in calls),
               "plain_ms": sum(r["plain_ms"] for r in calls),
               "library_ms": None if None in lib else sum(lib)}
        lim = {}
        for r in calls:
            for name, ms in limits(kernel, tuple(r["shape"]),
                                   r.get("rows")).items():
                lim[name] = lim.get(name, 0.0) + ms
        out["bound_ms"], out["bound_by"], out["bound_limit"] = _bound(lim)
        if kernel in SASS_KERNELS or kernel in NORM_OPS:
            # no launch goes under the floor
            out["floor_ms"] = FLOOR_MS * len(calls)
        return out

    out = []
    for kernel, (source, replaces) in KERNELS.items():
        extra = {}
        if kernel == "norm_dense_act":
            # One fused forward: one call per layer at the gate shape; one
            # decode step's calls beside.
            m, d, f = LM_BATCH * LM_SEQ, lm_cfg.d_model, lm_cfg.d_ff
            calls = [fused[(m, d, f)]] * lm_cfg.num_layers
            extra["decode_step"] = summed(
                kernel, [fused[(DECODE_SLOTS, d, f)]] * lm_cfg.num_layers)
        elif kernel in BATCHED_KERNELS:
            if kernel == "dense_batched_first_layer":
                calls = [moer[(kernel, MOE_UP)]]
            else:
                calls = [moer[(kernel, sh)] for sh in
                         moe_path_calls(moe_cfg, (MOE_UP, MOE_DOWN))]
            extra["decode_step"] = summed(kernel, [
                moer[(kernel, sh)] for sh in
                moe_path_calls(moe_cfg, (MOE_DECODE_UP, MOE_DECODE_DOWN))])
            if occ:
                # The same step at a real decode occupancy: one MoE call's
                # kept rows, for every call of the step.
                extra["decode_step_occupied"] = summed(kernel, [
                    occ[(kernel, sh)] for sh in moe_path_calls(
                        moe_cfg, (MOE_DECODE_UP, MOE_DECODE_DOWN))])
                extra["decode_step_occupied"]["rows"] = \
                    occ[(kernel, MOE_DECODE_UP)]["rows"]
        elif kernel in CACHE_KERNELS:
            # One decode step: one call per layer at the decode shape; the
            # prefill shape beside it.
            calls = [cache[(kernel, "decode")]] * lm_cfg.num_layers
            extra["decode_step_deepseek"] = summed(
                kernel, [cache[(kernel, "decode-moe")]] * moe_cfg.num_layers)
            extra["decode_step_audio"] = summed(
                kernel,
                [cache[(kernel, "decode-audio")]] * audio_cfg.num_layers)
            extra["prefill_per_call"] = per_call(cache[(kernel, "prefill")])
            extra["prefill_chunk_audio_per_call"] = per_call(
                cache[(kernel, "chunk-audio")])
        elif kernel in CNN_KERNELS:
            formulation = "var" if kernel == "dense_var" else "srm"
            calls = [cnn[(k, s)] for k, s in
                     main_path_calls(MAIN_BATCH, formulation) if k == kernel]
            if kernel == "dense":
                # Beside: one LM forward's and one LM decode step's calls.
                extra["lm_forward"] = summed(kernel, [
                    lmr[(k, s)] for k, s in lm_path_calls(lm_cfg)
                    if k == kernel])
                extra["decode_step"] = summed(
                    kernel, [dec[s] for s in lm_decode_calls(lm_cfg)])
                extra["prefill_chunk"] = summed(
                    kernel, [chunk[s] for s in lm_chunk_calls(lm_cfg)])
            if kernel == "dense_var":
                # Beside: one LM forward's dense calls in Eq. 7.
                extra["lm_forward"] = summed(kernel, [
                    lmr[(kernel, s)] for k, s in lm_path_calls(lm_cfg)
                    if k == "dense"])
        elif kernel == "layernorm":
            calls = [aud[(k, s)] for k, s in audio_path_calls(audio_cfg)
                     if k == kernel]
        else:
            calls = [lmr[(k, s)] for k, s in lm_path_calls(lm_cfg)
                     if k == kernel]
        if kernel == "rmsnorm":
            # Beside: one granite and one deepseek 4-slot decode step.
            for label, batch, cfg in (("decode_step", "lm-decode", lm_cfg),
                                      ("decode_step_deepseek", "moe-decode",
                                       moe_cfg)):
                extra[label] = summed(kernel, [
                    normdec[(batch, s)] for s in norm_decode_calls(cfg)])
        if kernel in AUDIO_KERNELS:
            # Beside: musicgen's forward (layernorm's own line) and step.
            for label, decode in (("audio_forward", False),
                                  ("audio_decode_step", True)):
                audio = [aud[(k, s)] for k, s in
                         audio_path_calls(audio_cfg, decode) if k == kernel]
                if audio and (decode or kernel != "layernorm"):
                    extra[label] = summed(kernel, audio)
        by_path = {path: counts.get(kernel, 0)
                   for path, counts in launches.items()}
        out.append({
            "name": kernel, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": errs[kernel],
            **summed(kernel, calls),
            "library": LIBRARY.get(kernel),
            **extra,
        })
    return out


def main():
    import torch
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the decode phase's requests")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (sets IEEE fp32 for cuBLAS and cuDNN)
    OUT_DIR.mkdir(exist_ok=True)
    device = torch.device("cuda")
    t0 = time.perf_counter()
    card = phase_card()
    build = phase_build()
    errs = phase_kernels(device)
    launches = {"cnn": phase_serving(device)}
    launches["lm"], lm_info, lm_cfg, lm_model = phase_lm(device)
    launches["decode"], decode_info = phase_decode(device, lm_cfg, lm_model,
                                                   args.seed)
    rows, forwards = phase_times(device, lm_cfg, lm_model)
    profile = phase_profile(device, lm_cfg, lm_model)
    del lm_model
    torch.cuda.empty_cache()
    moe_launches, moe_info, moe_cfg, moe_model = phase_moe(device)
    launches["moe"], launches["moe_var"] = (moe_launches["srm"],
                                            moe_launches["var"])
    launches["moe_decode"], moe_decode_info = phase_decode(
        device, moe_cfg, moe_model, args.seed,
        prompt_lens=(PREFILL_CHUNK, PREFILL_CHUNK),
        kernels=MOE_DECODE_KERNELS, tag="moe decode")
    moe_rows, moe_forward, moe_profile = phase_moe_times(
        device, moe_cfg, moe_model,
        moe_decode_info["occupancy"]["median_rows"])
    del moe_model
    torch.cuda.empty_cache()
    rows += moe_rows
    audio_launches, audio_info, audio_rows, audio_forward, audio_profiles, \
        audio_cfg = phase_audio(device)
    launches.update(audio_launches)
    rows += audio_rows
    torch.cuda.empty_cache()
    fused_launches, fused_info, fused_rows = phase_fused(device, args.seed,
                                                         errs)
    launches.update({k: v for k, v in fused_launches.items()
                     if k != "unfused"})
    rows += fused_rows
    torch.cuda.empty_cache()
    launches["train"], train_info = phase_train(device)
    forwards += [moe_forward, audio_forward]
    if moe_profile is not None:
        profile.append({"model": moe_cfg.name, "batch": LM_BATCH,
                        **moe_profile})
    for name, row in audio_profiles.items():
        if row is not None:
            profile.append({"model": f"{audio_cfg.name} {name}", **row})
    kernels = kernel_summary(rows, launches, errs, lm_cfg, moe_cfg,
                             audio_cfg)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "build": build, "kernels": kernels, "times": rows,
         "forwards": forwards, "profile": profile, "lm": lm_info,
         "decode": decode_info, "moe": moe_info,
         "moe_decode": moe_decode_info, "audio": audio_info,
         "fused": fused_info,
         "train": train_info,
         "seconds": time.perf_counter() - t0}, indent=1))
    print(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
