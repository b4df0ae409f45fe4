#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on one NVIDIA card.

    python3 chip_smoke.py [--profile]

1. Refuses to run without a CUDA device; prints the card's name and power
   limit as nvidia-smi reports them.
2. Builds the kernels (lora_tpu_torch/csrc, one nvcc per source for
   sm_90a) and prints the build time.
3. Flagship bank (4096 channels, SF10 CR 4/8, 32-byte payloads):
   a. holds kernels A (detect), B (track) and C (payload) against their
      plain PyTorch versions on the card at the shapes the bank gives
      them: integer outputs equal (except windows whose plain spectrum at
      the kernel's bin is within 1e-5 relative of the peak: float32 FFTs
      of another order may order a near tie the other way), dB values,
      f_index and fine_total within 1e-3; prints how many windows a
      candidate of kernel B transforms (it ends its scan at the sync);
   b. runs demodulate(fused="auto") and decode: every frame byte-exact,
      frame fields equal to fused="off", kernels A, B, C launched; then a
      4096-channel bank whose CFOs span the whole bin (half-bin offsets
      included) and 512 channels at the reference noise point (sigma 4.0)
      must each give the same frames and payloads on both routes;
   c. times each stage and the whole demodulate, kernel against plain.
4. Config-3 wideband bank (256 streams x 64 channels = 16,384 channels,
   SF7 CR 4/8, mtu 50, 10,240 samples per channel, 1.34 GB in):
   a. holds kernel D (channelize), which reads the filter history and the
      block through two pointers, against its plain version, the block-
      Toeplitz matrix product over their concatenation, with a random
      state and with none (a null history): the full-width bank, 16 streams
      at K = 16, 32 (one pass of the register FFT) and 192 (the direct
      sum), 8 at K = 128 and 2 at K = 1024 (two passes); max |y_D -
      y_plain| <= 1e-4 of max |y_plain| (float32 sums in another order),
      new_state equal;
   b. runs channelized_demodulate(fused="auto") and decode over frames on
      every even channel (16-byte payloads, delay in [0, N), CFO k + u bins
      with |u| < 0.4, random phase; merged by the synthesis bank; AWGN
      0.01 at the wideband rate): all 8,192 frames found and byte-exact,
      kernels D, A, B, C launched;
   c. against fused="off": on the 8,192 occupied channels found,
      payloads, t_sync, consumed, freq_error equal and symbols equal except
      at near ties (counted); the two banks within 1e-4 of their max.  An
      empty channel holds its neighbours' transition-band leakage, whose
      spectra sit at near ties, so the routes may differ there, on at most
      EMPTY_DIFFER of the empty channels, and neither may decode anything
      there but nothing, an empty packet or a neighbour's payload.  The
      difference has two parts, each shown on its own: kernels A, B, C
      against their plain versions on kernel D's bank, decision by decision
      (A and C by the rules of 3a; kernel B must equal the plain sync scan
      run over kernel A, every step of which is held against the plain
      detector on the same input), changing found on at most SAME_DIFFER
      of the empty channels and only where a decision parts; and kernel D's
      rounding under the plain route, on at most EMPTY_DIFFER, counted
      beside a control: the plain route against itself with complex noise
      of that rounding's rms added to the plain bank.  No comparison may
      differ on an occupied channel;
   d. times kernel D on (history, block) as the path gives them (no
      history: a null pointer) against its plain version on the
      concatenated stream, and the path on both routes, with the peak
      device memory above the input.
5. The receive options on the flagship bank (4096 channels, SF10, mtu 68):
   a. holds kernel E (the sub-window shift) against its plain version,
      bit-equal (it is a copy), at the payload geometry (mtu + 1 rows, the
      bank's own data starts, with r = 0, 1 and N - 1 among them) and at
      the track geometry (18 rows, 17 windows), and times it against
      torch.take_along_dim over the same windows;
   b. holds kernel C's |X|^2 output against the plain version: value,
      power and noise by the rules of 3a, mag2 within 1e-4 of each
      window's peak, argmax(mag2) equal to value except at near ties;
   c. runs demodulate(debug=True, fused="auto"): kernels A, B, E launched,
      raw equal to the fused="off" route's, dec and fft_mag2 within 1e-4
      of their window's largest value, the frame fields equal, payloads
      byte-exact;
   d. runs demodulate(spectra=True) and decode_soft on both routes:
      kernels A, B, C launched, statuses and payload bytes equal between
      the routes, every frame byte-exact; on the 512-channel bank at sigma
      4.0 soft decoding must recover at least as many frames as hard
      decoding (both counts printed);
   e. on buffers of 2 * required_samples with a second frame after the
      first's end: holds kernels B and C (with mag2) against their plain
      versions at the [B, 2] candidate offsets the path gives them, by the
      rules of 3a and 5b; runs demodulate(max_frames=2): both frames found
      and byte-exact, fields equal between the routes, kernels A, B, C
      launched once each (not once per candidate);
   f. times kernel C with and without mag2 and each of these paths on
      both routes, with the debug route's peak device memory above the
      bank.
   Times are CUDA events, the median of 7 after a warm-up, the better of
   two interleaved sets (plain, kernel, kernel, plain).  With the option
   --profile, steps 3, 4 and 5 also print each path's device time by kernel
   (torch.profiler over three warm calls) and the device's idle share.
6. The streaming runtime, slab execution and capture replay at the flagship
   config (SF10, CR 4/8, mtu 68), data made on the card from the seed:
   a. StreamDemodulator(channels=4096) on the card, driven by pump() over
      host complex64 blocks of 16,384 samples (as an SDR delivers them):
      each channel carries 3 frames at random gaps, one CFO a channel
      (|u| < 0.4 bins), AWGN 0.1, over at least two device steps; frames
      cross block seams and the first window's end.  Every frame found
      once, byte-exact, t_start within 1 sample of where it was placed, no
      extra frame with status OK, kernels A, B, C once a step; feed/run
      gives the same frames and read pointers, and so does a save_state /
      load_state round trip in the middle of the stream.  Prints the
      steps, the ingest rate (channels x samples over the wall time), ms a
      step and the peak device memory (with --profile, the idle share);
   b. demodulate_bank over a host bank of 10,240 channels (BASELINE.json
      config 5's 10k+ channels) in pinned slabs of 4096: every field
      bit-equal to demodulate of each slab alone, every frame byte-exact;
      ms per bank (with --profile, whether copies and kernels overlap);
   c. replay_file of cf32 captures written from the port's tx path: at 8x
      the channel rate with the frame on channel 3 and a DC offset
      (dc_block=True; kernel D launched), and at the fractional ratio
      4.096 with the frame across the 2^22-sample chunk seam (the
      resampler, whose chunked output is bit-equal to the unchunked one on
      the card): each frame byte-exact;
   d. (run after a) StreamDemodulator.pump over 1024 such streams with
      soft=True and with max_frames=3, each on fused="auto" and "off",
      captured and under utils.jit.disable_jit(): every frame found once
      and byte-exact, the captured run's frames equal to the eager run's
      in every field (soft confidence included), the routes' frames equal
      in their decisions, kernels A, B, C once a step on "auto" and none
      on "off".
7. The multi-device paths (lora_tpu_torch.parallel) on ranks spawned by
   parallel.dryrun.launch after the parent frees its banks: two ranks on
   this one card over gloo (NCCL refuses two ranks on one device), then
   one rank over NCCL; each rank makes the data on the card from the seed
   and first checks that its backend takes comm.py's collectives for CUDA
   tensors:
   a. shard_demodulate of the flagship bank (2048 rows a rank; 4096 on
      the NCCL rank), decode and aggregate_metrics under the sharding:
      every field of the gathered result equal to rank 0's whole-bank
      demodulate (floats within 1e-3, and whether bit-equal), every
      payload byte-exact, the all-reduced counts equal and the means
      within 1e-5 of their size (float32 sums in another order; gloo and
      NCCL);
   b. demodulate_stream at time 2, max_frames = 2, over 4096 flagship
      channels of 2 x 102,400 samples: frames straddling the boundary, 2
      samples before it, just after it and two in shard 0's region (one
      CFO a channel, |u| < 0.4, AWGN 0.1): every frame claimed once, by
      its owner, t_sync global within 1, byte-exact, and on every channel
      the same t_sync as one demodulate(max_frames=2) of the global bank
      (gloo);
   c. channelize_stream of the config-3 bank (256 x 655,360, K = 64, L =
      8) over the time shards, then shard_demodulate of the 16,384
      channels: kernel D across the seam against one channelize of the
      whole stream (within 1e-4, and whether bit-equal), the occupied
      channels equal to single-process channelized_demodulate and
      byte-exact (gloo and NCCL);
   d. ChannelDispatcher with a mesh over 4096 channels, SF7 to SF12 round
      robin, CR 4/8, 32-byte payloads, hard and soft: every channel found,
      status 0, byte-exact, equal to the dispatcher without a mesh (gloo);
      first, on rank 0, kernels A, B and C (C with and without mag2) at
      each SF group's shapes against the plain route, as in 3b and 5d:
      demodulate(fused="auto") and "off" equal in every decision field,
      fine_freq, power and snr within 1e-3, fft_mag2 within 1e-4 of each
      window's peak.
   Every path counts the kernels from 0 in each rank (A, B, C on every
   path, D in 7c, E on none) and prints its time (barrier to barrier)
   beside the single-process call, the bytes and time of each collective
   (comm.py's functions wrapped in the rank, a device sync on each side)
   and each rank's peak device memory.  The ranks share the card's SMs and
   gloo moves CUDA tensors through the host: these times are the
   collectives' cost, not scaling.
8. The last modules of the port:
   a. lora_tpu_torch.benchmarks --validate at its full rungs (SF10 "off"
      at B = 512, "auto" at 2048 and 4096, SF12 "auto" at 1024): its
      record printed, value > 0, every rung present with its median, min
      and max, the bf16 decision check ok; each rung's run counted (A, B,
      C on the "auto" rungs, no kernel on the "off" rung), then run again
      outside the profiler for the record's times;
   b. kernel D's bf16 route (route 3: the FIR output rounded to bfloat16,
      the IDFT by the rounded matrix on the tensor cores, float32 sums)
      against filterbank_fir_plain at the config-3 shape and at K = 16,
      192 and 1024, with a state and with none: at least 99% of the
      samples within 1e-5 of the peak and all within 1e-2 (a float32 step
      of the FIR output can move its bfloat16 rounding by one step, and
      the tensor cores sum in another order), and whether bit-equal;
      within lora_tpu's bf16 bar, 3e-2, of the float32 kernel;
      channelized_demodulate(fused="bf16") on the config-3 bank: all 8,192
      frames found and byte-exact, kernels D, A, B, C launched, the
      occupied channels' fields that differ from fused="auto" counted;
      times of kernel D bf16 against its plain version and the float32
      route, of the bf16 path beside "auto", and, as a yardstick of the
      IDFT alone, of torch.matmul on the bf16 [S*M, 2K] x [2K, 2K] real
      product;
   c. utils.trace.profile around one flagship demodulate(fused="auto")
      call: the Chrome trace names kernels A, B and C once each (the
      session's opening launches took torch.profiler's drop of its first
      device records, which grows with the process's age); frame_events
      gives one event a channel.
9. The port's tools and examples (lora_tpu_torch.tools, .examples), each
   path's kernels counted from 0, each sub-step's time printed:
   a. the paired sensitivity matrix: the 60 points of
      docs/sensitivity_vs_reference.json at each row's n (2,720 frames),
      each bank rebuilt draw for draw as lora_tpu built it
      (bench_sensitivity.make_bank, in threads ahead of the card) and given
      to fused="auto" (kernels A, B, C; C with mag2) and to fused="off",
      hard and soft.  The routes' found and hard- and soft-recovered flags
      differ on at most 13 frames (0.5%), each difference printed; the
      kernels' hard total is at least the reference FSM's committed 1,102
      and no point more than one frame below its recovered_ref; the
      kernels' hard and soft totals are within 27 frames (1%) of lora_tpu's
      committed 1,207 and 1,968.  Each point's delta against lora_tpu and
      the reference is printed;
   b. bench_e2e (config 5: cs16 wire, ingest thread, pinned staging, slabs
      of 2048 SF10 channels, demodulate and decode, a depth-1 readback)
      over 10,240 channels in the planar int16 mode, then 2 slabs in the
      host-convert and interleaved modes and with --mixed-sf: every frame
      found and decoded ok in each; the record, the compute-only rate and
      the measured host-to-device rate printed, from a second run outside
      the profiler (the wire is built before 9a, outside every counted
      run);
   c. bench_soft and bench_decode at B = 2048, SF10, each path gated on
      every frame byte-exact before it is timed;
   d. bench_stream's bench_pump at its card defaults (every pass the same
      frames, each frame within the stream's reach found once and
      byte-exact), examples.wideband_rx (kernel D, then A, B, C; byte-exact)
      and examples.lora_simulation with piped lines, whose two messages
      (SF10, then /sf 8) come back byte-exact.

10. The captured programs (lora_tpu_torch/utils/jit.py: demodulate,
   soft_symbols and channelized_demodulate each one CUDA graph per
   static arguments) at full width on the banks of steps 3, 4 and 5e: the
   flagship bank, config 3, spectra=True + decode_soft, max_frames=2 and
   debug=True, each on both routes (and max_frames=2 on a second bank,
   whose frames are counted, not gated): the first call and a replay
   bit-equal in every field to
   the call under disable_jit(), frames byte-exact, no capture over the
   timed calls, one replay on the resident input under
   torch.cuda.set_sync_debug_mode("error"), eager and captured times (CUDA
   events, median, min and max of 14 calls each, in the order eager,
   captured, captured, eager), with --profile each one's idle share
   (utils.trace.session), and the memory the flagship graph's pool holds.
11. The transmit half at the flagship bank (4096 frames of 32 bytes, SF10
   CR 4/8, seed 1234): encode's first call and a replay (under
   torch.cuda.set_sync_debug_mode("error")) bit-equal to its call under
   disable_jit(); encode then modulate counted from 0: kernel F (modulate)
   launched once and nothing else; kernel F bit-equal to modulate_plain
   (were the card's cosf/sinf and torch's cos/sin ever to part, the
   largest difference is printed with the reason and held to 2.4e-7);
   the F-built bank and the plain-built bank through the same impair and
   noise: equal demodulate decisions and every frame byte-exact through
   decode (kernels A, B, C, not F); dcblock captured bit-equal to
   disable_jit() on two replay-sized blocks with the state across the
   seam, a replay free of host syncs; times (CUDA events, median, min
   and max of 14 calls in the order eager, captured, captured, eager) of
   encode eager and captured, modulate plain and kernel F, dcblock eager
   and captured; the peak device memory of modulate on each route.
12. Kernel G (decode in one launch) at both cells' shapes: 4096 frames of
   SF10 CR 4/8 (68 int16 symbols each, as the flagship bank's demodulate
   gives them) and 256 x 64 frames of SF7 CR 4/5 (60 symbols, the
   wideband cell's [streams, channels, mtu]), each half encoded 32-byte
   payloads and half random symbols: every field held to 0 against
   decode_plain, one launch a call (counted from 0), the encoded half
   decoded OK; kernel G's device time (torch.profiler, 14 calls) beside
   its bound by bytes; times (CUDA events, median, min and max of 14 calls
   in the order plain, kernel, kernel, plain) of a call of kernel G (its
   wrapper's host time within), of decode_plain captured as one CUDA graph
   (the route decode took before kernel G) and of decode_plain eager.
13. Kernel R (the fractional resampler) against its plain version at the
   US902-928 cell's shape (8,192 channels of 65,536 samples -> 40,960,
   ratio 8/5, 14 taps): its register-blocked route (the plan's period, the
   profiler's blocked launches), bit-equal, one launch a call; its
   device time by torch.profiler and its share of its bound, the plain
   route's by CUDA events; the general route's device time on the same
   plan and on 4.096's (no short period, the same rows, bit-equal too).
   Kernel R also runs in step 6c's fractional replay (4.096 and its
   inverse, the general route), which counts it.

On the card every call of these entry points in steps 3 to 9 runs
captured too (its first call at a key is the warm-up, whose result it
returns); each step starts with the programs' caches cleared.  Paths that
build their own bank on the card (9a, 9c, 9d) launch kernel F too; every
receive path reads 0 for it.  Kernel G runs wherever a path decodes, on
both routes (decode follows no route): step 3's slice, 5d, the decode of
step 6's streamed frames and both replays, 7a, 7d, 9a to 9d, step 10's
soft path and step 12.

A path's launches are counted from the device record of a torch.profiler
session around one untimed run of it (`count_launches`; utils/trace.launches
names each kernel family); a path whose run is also timed (6a, 6d, 8a, 9b)
runs once more outside the profiler for its times.

Prints the kernels' JSON line (kernels A to G and R: launches summed over the
driven paths, step 6's StreamDemodulator.pump, demodulate_bank and both
replays, step 7's paths (summed over their ranks), step 8's and step 9's
among them, and, in launches_by_path, of each path's run alone, every
kernel counted on every path; the error against the plain version,
the kernel's, the plain version's and, for kernel E, one PyTorch call's
time, and the bound: the larger of the bytes each input and output must
move over 3.35 TB/s and the float32 operations over 67 TFLOP/s; kernel D's
row carries its bf16 route's error, times, bound, route and the matmul
yardstick under "bf16"; kernel F's row, "replaces" the XLA fusion it
stands for, no pallas_call; kernel G's row, its error from step 12, its
times at the SF10 bank's shape and under "wideband" at the wideband
cell's, beside the captured plain route's; every other
number of a row is measured in this run), then {"ok": true, "device": {...}}
last.  Any failure raises and exits non-zero.  Imports no jax.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import sys
import time

import numpy as np

# the card's published peaks and the bound by them, the flops of a window
# and the banks' impairments are the benchmark's (phybench's)
from phybench.device import HBM_RATE, bound_s, window_flops
from phybench.inputs import awgn, impair

SEED = 1234
B_FLAGSHIP = 4096
B_NOISY = 512
SIGMA = 0.1
SIGMA_NOISY = 4.0  # the reference's verified operating point (BASELINE.md)
TOL = 1e-3
TIE_RTOL = 1e-5
RUNS = 7
# config 3 (tools/bench_config3_stages.py:80-84): K channels per stream
C3_STREAMS = 256
C3_K = 64
C3_SIGMA = 0.01
# kernel D parity shapes (K, streams, samples per channel; None: the
# config's): the full-width bank, then each geometry the JAX package gives
# its other kernels, K = 192 (the direct sum) and two more widths that take
# two passes of the register FFT (an odd M keeps the plain product's matrix
# at K = 1024 small)
C3_PARITY = ((C3_K, C3_STREAMS, None), (16, 16, None), (32, 16, None),
             (192, 16, None), (128, 8, None), (1024, 2, 2049))
D_RTOL = 1e-4
# Empty config-3 channels hold their neighbours' leakage, on which the sync
# scan's decisions may go either way.  Shares of the 8,192 empty channels on
# which they may: found changed by the demod kernels on kernel D's bank
# (seen on the card: 12 and 27 at AWGN 0.01 and 0.1), and found or payload
# changed between the routes (seen: 36 and 56) or by kernel D's rounding
# under the plain route (seen: 46 at AWGN 0.01; 49 for noise of that
# rounding's rms on the plain bank).
SAME_DIFFER = 0.005
EMPTY_DIFFER = 0.01
# step 5: taps and spectra, as a share of each window's largest value
TAP_RTOL = 1e-4
# step 6 (flagship config): streams of host blocks, a slab bank (the "10k+
# channels" of BASELINE.json config 5), capture replay
STREAM_CHANNELS = 4096
STREAM_BLOCK = 16384
STREAM_FRAMES = 3
STREAM_RUN_PASSES = 3
# step 6d: the soft and three-frame streams, each on both routes, captured
# and eager
STREAM_MODES_CHANNELS = 1024
SLAB_CHANNELS = 10240
SLAB = 4096
REPLAY_K = 8
REPLAY_CHANNEL = 3
REPLAY_CHUNK_K = 1 << 19
REPLAY_RATIO = 4.096
REPLAY_CHUNK = 1 << 22
# the fields of a step's result that the stream's decisions read
DECIDE = ("found", "found_pre", "payload_complete", "t_sync", "consumed",
          "count", "freq_error", "symbols", "t_candidate")


def bound(nbytes: float, flops: float, bf16_flops: float = 0.0) -> dict:
    """phybench's bound_s in ms (each input read once and each output
    written once at the memory rate, or the float32 `flops` and the
    bfloat16 products `bf16_flops` at their rates, whichever is larger),
    and which of the two bounds it."""
    s = bound_s(nbytes, flops, bf16_flops)
    return {"bound_ms": s * 1e3,
            "bound_by": "bytes" if s == nbytes / HBM_RATE else "operations"}


def flagship_cfg():
    from lora_tpu_torch import LoRaConfig

    cfg = LoRaConfig(sf=10, cr="4/8", ampl=1.0)
    return cfg.replace(mtu=cfg.num_symbols(32) + 4)


def config3_cfg():
    from lora_tpu_torch import LoRaConfig

    cfg = LoRaConfig(sf=7, cr="4/8", ampl=1.0)
    return cfg.replace(mtu=cfg.num_symbols(16) + 2)


def make_bank(api, cfg, B: int, sigma: float, seed: int, dev,
              u_max: float = 0.4):
    """B channels, one frame each at a random delay in [0, 3N), a random
    phase and a CFO of k + u bins (k in -2..2, |u| < u_max), plus AWGN;
    made on the card.  Fractional CFOs near half a bin split every preamble
    peak between two bins, and the coarse search of both packages then
    loses about one frame in a thousand, so the byte-exact bank stays
    clear of them as tests/test_loopback.py does; u_max = 0.5 covers the
    whole bin."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    payload = torch.randint(0, 256, (B, 32), generator=g, device=dev,
                            dtype=torch.int64).to(torch.uint8)
    iq = api.modulate(api.encode(payload, cfg), cfg)
    T = api.required_samples(cfg)
    bank = impair(iq, T, cfg.N, g, 3 * cfg.N, 2, u_max)
    del iq
    bank = (bank + awgn(bank.shape, sigma, g, dev)).contiguous()
    return bank, payload


def make_wideband(api, chz, cfg, S: int, K: int, sigma: float, seed: int,
                  dev):
    """S wideband streams of K channels with a frame (16-byte payload,
    delay in [0, N), CFO k + u bins with |u| < 0.4, random phase) on every
    even channel, merged by the synthesis bank, plus AWGN at the wideband
    rate; made on the card.  -> (wide [S, M*K], payload [S, K/2, 16])."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    M = api.required_samples(cfg)
    F = S * (K // 2)
    payload = torch.randint(0, 256, (F, 16), generator=g, device=dev,
                            dtype=torch.int64).to(torch.uint8)
    frames = impair(api.modulate(api.encode(payload, cfg), cfg), M, cfg.N,
                    g, cfg.N, 2, 0.4)
    u = torch.zeros((S, K, M), dtype=torch.complex64, device=dev)
    u[:, 0::2] = frames.reshape(S, K // 2, M)
    del frames
    wide, _ = chz.synthesize(u)
    del u
    wide = (wide + awgn(wide.shape, sigma, g, dev)).contiguous()
    return wide, payload.reshape(S, K // 2, 16)


class Check:
    """Kernel-vs-plain comparison record of one kernel."""

    def __init__(self, name):
        self.name = name
        self.max_abs_err = 0.0
        self.ties = 0

    def close(self, what, got, want, tol=TOL, mask=None):
        d = (got.float() - want.float()).abs()
        if mask is not None:
            d = d[mask]
        err = float(d.max()) if d.numel() else 0.0
        self.max_abs_err = max(self.max_abs_err, err)
        if not err <= tol:
            raise AssertionError(
                f"{self.name}: {what} differs by {err} > {tol}"
            )

    def close_rel(self, what, got, want, rtol):
        """Complex outputs: max |got - want| <= rtol * max |want|."""
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        self.max_abs_err = max(self.max_abs_err, err)
        if not err <= rtol * scale:
            raise AssertionError(f"{self.name}: {what} differs by {err} > "
                                 f"{rtol} * {scale}")
        return err / scale

    def equal(self, what, got, want):
        bad = int((got != want).sum())
        if bad:
            raise AssertionError(f"{self.name}: {what} differs in {bad} places")

    def values(self, got, want, spectra):
        """Integer bins equal except near ties: `spectra(idx)` returns the
        plain |X|^2 rows of the mismatching windows (flat indices idx)."""
        import torch

        diff = (got != want).reshape(-1)
        idx = torch.nonzero(diff).reshape(-1)
        if idx.numel():
            m2 = spectra(idx)
            k = got.reshape(-1)[idx].long()
            at_k = torch.gather(m2, 1, k[:, None])[:, 0]
            peak = m2.amax(-1)
            tie = (peak - at_k) <= TIE_RTOL * peak
            if not bool(tie.all()):
                raise AssertionError(
                    f"{self.name}: {int((~tie).sum())} bins differ beyond "
                    "a near tie"
                )
            self.ties += int(idx.numel())
        return ~diff.reshape(got.shape)


def check_detect(chk, det_ops, cuda_detect, x, down, fe, want_findex):
    """Kernel A vs plain on windows x [..., N]."""
    import torch

    k = cuda_detect.dechirp_detect(x, down, fe, want_f_index=want_findex)
    p = det_ops.dechirp_detect(x, down, fe, want_f_index=want_findex)
    N = x.shape[-1]

    def spectra(idx):
        xf = x.reshape(-1, N)[idx]
        ff = None if fe is None else torch.broadcast_to(
            fe, x.shape[:-1]).reshape(-1)[idx]
        return det_ops.dechirp_detect(xf, down, ff, want_mag2=True).mag2

    ok = chk.values(k.value, p.value, spectra)
    chk.close("power", k.power, p.power, mask=ok)
    chk.close("noise", k.noise, p.noise, mask=ok)
    if want_findex:
        chk.close("f_index", k.f_index, p.f_index, mask=ok)
    return k, ok


def payload_spectra(det_ops, bank, ds, fine, N: int, mtu: int):
    """Plain |X|^2 of payload windows (flat index b * mtu + w) of buffers
    bank [B, T] from data starts ds [B], derotated by fine [B]."""
    import torch

    def spectra(idx):
        b = idx // mtu
        start = ds.long()[b] + (idx % mtu) * N
        xw = torch.take_along_dim(
            bank[b], start[:, None] + torch.arange(N, device=bank.device),
            dim=1)
        return det_ops.dechirp_detect(xw, ferr=fine[b],
                                      want_mag2=True).mag2

    return spectra


def fresh(torch) -> None:
    """Drop every captured program's graphs, buffers and pools
    (utils/jit.py) and the cached device memory: between steps, whose
    banks differ."""
    from lora_tpu_torch.utils import jit

    jit.clear()
    torch.cuda.empty_cache()


def run_times(fn) -> list:
    """ms of RUNS calls of fn by CUDA events, each call alone."""
    import torch

    times = []
    for _ in range(RUNS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return times


def in_turns(run_a, run_b):
    """(ms of run_a, ms of run_b): RUNS CUDA-event calls each, twice, in
    the order a, b, b, a, each set after a warm-up call."""
    ms = ([], [])
    for i in (0, 1, 1, 0):
        fn = (run_a, run_b)[i]
        fn()
        ms[i].extend(run_times(fn))
    return ms


def unjitted(fn):
    """fn called under utils.jit.disable_jit(): the eager route."""
    from lora_tpu_torch.utils import jit

    def run():
        with jit.disable_jit():
            return fn()
    return run


def timed(fn, sync):
    """Median ms of RUNS calls after one warm-up, by CUDA events."""
    fn()
    sync()
    times = sorted(run_times(fn))
    return times[len(times) // 2]


def interleaved(kern, plain, sync):
    """(kernel ms, plain ms): the better of two interleaved sets, in the
    order plain, kernel, kernel, plain, so that the two orders cancel
    drift."""
    p1 = timed(plain, sync)
    k1 = timed(kern, sync)
    k2 = timed(kern, sync)
    p2 = timed(plain, sync)
    return min(k1, k2), min(p1, p2)


def peak_above(fn, sync) -> float:
    """GB of device memory a call allocates at its peak above what is
    allocated before it (its inputs)."""
    import torch

    sync()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    sync()
    return (torch.cuda.max_memory_allocated() - base) / 1e9


def count_launches(what, fn, sync, expect, exactly=None):
    """Drive one path, untimed, inside a profiler session
    (utils/trace.session) and count its kernels from the session's device
    record (utils/trace.launches); check them (`check_launches`).  ->
    (fn's result, {kernel: launches})."""
    from lora_tpu_torch.utils import trace

    with trace.session() as prof:
        out = fn()
        sync()
    launches = trace.launches(prof)
    check_launches(what, launches, expect, exactly)
    return out, launches


def check_launches(what, launches, expect, exactly=None):
    """Every kernel of `expect` must have been launched (`exactly` that
    many times, if given) and no other kernel at all."""
    from lora_tpu_torch.utils import trace

    print(f"launches in the {what} run: {launches}", flush=True)
    for k in trace.KERNELS:
        n = launches[k]
        if k in expect and (n <= 0 or (exactly is not None and n != exactly)):
            raise AssertionError(f"{what}: kernel {k} launched {n} times")
        if k not in expect and n:
            raise AssertionError(f"{what}: kernel {k} is not on this path "
                                 f"and was launched {n} times")


def both_routes(run, sync):
    """{route: ms} of run(route): the better of two interleaved sets."""
    ms = {}
    for route in ("off", "auto", "auto", "off"):
        t_ms = timed(lambda: run(route), sync)
        ms[route] = min(ms.get(route, t_ms), t_ms)
    return ms


def scan_windows(torch, x, t0, cfg):
    """What kernel B's scan costs on these candidates, replayed from the
    plain scan's step log: -> (windows a candidate transforms: its steps up
    to the sync, or all 13 without one, a lookahead at each step whose sync
    test reads it, and the downchirp pair; distinct windows it reads)."""
    from lora_tpu_torch.ops import cuda_demod
    from lora_tpu_torch.ops import detect as det_ops
    from lora_tpu_torch.ops.tables import N_SCAN

    log = []
    trk = cuda_demod.track_plain(x, t0, cfg.sync, cfg.thresh, cfg.N,
                                 detect=logged(det_ops.dechirp_detect, log))
    _, v, s = (torch.stack(c) for c in zip(*log[:-1]))  # [steps, candidates]
    q = (v[..., 0] + 4) // 8
    prev_q = torch.cat([torch.full_like(q[:1], 999), q[:-1]])
    look = (s >= cfg.thresh) & (prev_q == 0) & (q == cfg.sync >> 4)
    synced, k_sync = trk["synced"].reshape(-1), trk["k_sync"].reshape(-1)
    last = torch.where(synced, k_sync, N_SCAN - 1)
    active = torch.arange(N_SCAN, device=x.device)[:, None] <= last
    transformed = active.sum(0) + (look & active).sum(0) + 2
    distinct = torch.where(synced, k_sync + 4, N_SCAN)
    return transformed, distinct


def hold_window_kernels(torch, bank, cfg, dev, sync):
    """Step 3a: kernels A, B and C against their plain versions at the
    shapes the flagship bank gives them, on whatever library the wrappers
    load.  -> (checks by kernel, t0, data_start, fine_total, scan): the
    inputs of the track and payload stages, taken from the plain versions,
    and scan_windows of the track stage."""
    from lora_tpu_torch.models import demodulator as dm
    from lora_tpu_torch.ops import cuda_demod, cuda_detect
    from lora_tpu_torch.ops import detect as det_ops

    N, mtu = cfg.N, cfg.mtu
    B, T = bank.shape
    W = T // N
    win = bank[:, : W * N].reshape(B, W, N)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    chk_a = Check("detect")
    check_detect(chk_a, det_ops, cuda_detect, win, False, None, False)
    for n_win in (1024, 128):
        rnd = awgn((65536, n_win), 1.0, gen, dev)
        fe = torch.rand(65536, generator=gen, device=dev) - 0.5
        for down in ((False, True) if n_win == 1024 else (False,)):
            check_detect(chk_a, det_ops, cuda_detect, rnd, down, fe, True)
    del rnd
    sync()
    print(f"kernel A parity: ok, {chk_a.ties} near-tie windows, "
          f"max |err| {chk_a.max_abs_err:.3g}", flush=True)

    v, snr0, pwr = dm._coarse_detect(bank, cfg, False)
    t_cand, t0, found_pre = dm._align_frame(v, snr0, pwr, cfg, T)
    chk_b = Check("track")
    kb = cuda_demod.track(bank, t0, cfg.sync, cfg.thresh, N)
    pb = cuda_demod.track_plain(bank, t0, cfg.sync, cfg.thresh, N)
    for f in ("synced", "k_sync", "freq_error"):
        chk_b.equal(f, kb[f], pb[f])
    for f in ("fine_total", "power", "snr"):
        chk_b.close(f, kb[f], pb[f])
    sync()
    scan = scan_windows(torch, bank, t0, cfg)
    print(f"kernel B parity: ok, max |err| {chk_b.max_abs_err:.3g}; a "
          f"candidate transforms {float(scan[0].float().mean()):.2f} windows "
          f"on average (at most {int(scan[0].max())}) and reads "
          f"{float(scan[1].float().mean()):.2f} distinct ones; the plain scan "
          "transforms 28 and reads 17", flush=True)

    head, fine_total = dm._head(pb, cfg, t0, t_cand, found_pre, T)
    ds = head.consumed
    chk_c = Check("payload")
    kc = cuda_demod.payload_detect(bank, ds, fine_total, mtu, N)
    pc = cuda_demod.payload_detect_plain(bank, ds, fine_total, mtu, N)
    ok = chk_c.values(kc[0], pc[0],
                      payload_spectra(det_ops, bank, ds, fine_total, N, mtu))
    chk_c.close("power", kc[1], pc[1], mask=ok)
    chk_c.close("noise", kc[2], pc[2], mask=ok)
    sync()
    print(f"kernel C parity: ok, {chk_c.ties} near-tie windows, "
          f"max |err| {chk_c.max_abs_err:.3g}", flush=True)
    checks = {"detect": chk_a, "track": chk_b, "payload": chk_c}
    return checks, t0, ds, fine_total, scan


def flagship(torch, dev, card, sync, profile=False):
    """Step 3: the SF10 flagship bank.  -> (checks, launches, ms)."""
    from lora_tpu_torch import api
    from lora_tpu_torch.models import demodulator as dm
    from lora_tpu_torch.ops import cuda_demod, cuda_detect
    from lora_tpu_torch.ops import detect as det_ops

    cfg = flagship_cfg()
    N, mtu = cfg.N, cfg.mtu
    bank, payload = make_bank(api, cfg, B_FLAGSHIP, SIGMA, SEED, dev)
    B, T = bank.shape
    W = T // N
    win = bank[:, : W * N].reshape(B, W, N)
    print(f"bank: B={B} T={T} ({W} windows of N={N}), mtu={mtu}, "
          f"{bank.numel() * 8 / 1e9:.2f} GB complex64", flush=True)

    # ---- a. kernels vs plain at the flagship shapes ----------------------
    checks, t0, ds, fine_total, scan = hold_window_kernels(torch, bank, cfg,
                                                           dev, sync)

    # ---- b. the slice through the kernels --------------------------------
    def slice_():
        d = api.demodulate(bank, cfg, fused="auto")
        return d, api.decode(d.symbols, cfg)

    (dem, dec), launches = count_launches(
        "demodulate(fused='auto') + decode", slice_, sync,
        ("detect", "track", "payload", "decode"))
    lost = (~dem.found).nonzero().reshape(-1).tolist()
    if lost:
        raise AssertionError(f"{len(lost)} of {B} frames not found: {lost}")
    got = api.extract_payloads(dec)
    want = [bytes(p) for p in payload.cpu().numpy().tolist()]
    bad = [i for i in range(B) if got[i] != want[i]]
    if bad:
        raise AssertionError(f"{len(bad)} of {B} payloads not byte-exact: "
                             f"{bad}")
    for f in ("symbols", "count", "power", "snr", "fine_freq"):
        d = getattr(dem, f)
        if d.dtype.is_floating_point and not bool(torch.isfinite(d).all()):
            raise AssertionError(f"non-finite {f}")
    ref = api.demodulate(bank, cfg, fused="off")
    for f in ("found", "symbols", "t_sync", "consumed", "freq_error"):
        if not torch.equal(getattr(dem, f), getattr(ref, f)):
            raise AssertionError(f"fused='auto' and 'off' differ in {f}")
    print(f"slice: {B}/{B} frames found and byte-exact; found, symbols, "
          "t_sync, consumed, freq_error equal to fused='off'", flush=True)
    del ref, dec

    for what, n_ch, sigma, seed, u_max in (
        ("whole-bin CFO", B_FLAGSHIP, SIGMA, SEED + 3, 0.5),
        ("reference noise point", B_NOISY, SIGMA_NOISY, SEED + 2, 0.4),
    ):
        other, opay = make_bank(api, cfg, n_ch, sigma, seed, dev, u_max)
        dems = [api.demodulate(other, cfg, fused=r) for r in ("auto", "off")]
        for f in ("found", "symbols", "t_sync", "consumed", "freq_error"):
            if not torch.equal(getattr(dems[0], f), getattr(dems[1], f)):
                raise AssertionError(f"{what}: the routes differ in {f}")
        outs = [api.extract_payloads(api.decode(d.symbols, cfg))
                for d in dems]
        if outs[0] != outs[1]:
            raise AssertionError(f"{what}: the routes' payloads differ")
        owant = [bytes(p) for p in opay.cpu().numpy().tolist()]
        good = sum(g == w for g, w in zip(outs[0], owant))
        print(f"{what} (sigma={sigma}, |u| < {u_max}): B={n_ch}, both routes "
              f"equal, {int(dems[0].found.sum())} found, {good}/{n_ch} "
              "payloads byte-exact", flush=True)
        del other, dems

    # ---- c. times ---------------------------------------------------------
    stages = {
        "detect": (
            lambda: cuda_detect.dechirp_detect(win, want_f_index=False),
            lambda: det_ops.dechirp_detect(win, want_f_index=False),
        ),
        "track": (
            lambda: cuda_demod.track(bank, t0, cfg.sync, cfg.thresh, N),
            lambda: cuda_demod.track_plain(bank, t0, cfg.sync, cfg.thresh, N),
        ),
        "payload": (
            lambda: cuda_demod.payload_detect(bank, ds, fine_total, mtu, N),
            lambda: cuda_demod.payload_detect_plain(bank, ds, fine_total,
                                                    mtu, N),
        ),
    }
    ms = {}
    for name, (kern, plain) in stages.items():
        ms[name] = interleaved(kern, plain, sync)
        print(f"time {name}: kernel {ms[name][0]:.3f} ms, plain "
              f"{ms[name][1]:.3f} ms (B={B}, N={N}) [{card}]", flush=True)
    e2e = both_routes(lambda route: api.demodulate(bank, cfg, fused=route),
                      sync)
    for route in ("auto", "off"):
        rate = B * T / (e2e[route] * 1e-3) / 1e6
        print(f"time demodulate fused={route!r}: {e2e[route]:.3f} ms, "
              f"{rate:.1f} Msamples/s (B={B}, T={T}) [{card}]", flush=True)
    if profile:
        device_breakdown("demodulate(fused='auto')",
                         lambda: api.demodulate(bank, cfg, fused="auto"),
                         e2e["auto"], sync, top=12)
    # the track stage ends a candidate's scan at its sync: the windows this
    # bank makes it read and transform (scan_windows), not the most it could
    bounds = {
        "detect": bound(B * W * (N * 8 + 12), B * W * window_flops(N, False)),
        "track": bound(float(scan[1].sum()) * N * 8 + B * 24,
                       float(scan[0].sum()) * window_flops(N, True)),
        "payload": bound(B * mtu * (N * 8 + 12),
                         B * mtu * window_flops(N, True)),
    }
    return checks, launches, ms, bounds


def coarse_marginal(v, snr0, pwr, cfg):
    """Channels [B] of the coarse search [B, W] with a decision within
    4 * TOL dB of its threshold: a pair's SNR (power less noise, each within
    TOL) against cfg.thresh, or its score against the 6 dB window of
    _align_frame (a difference of two such SNRs)."""
    import torch
    from lora_tpu_torch.models import demodulator as dm

    agree, pair_snr = dm._coarse(v, snr0, pwr, cfg)
    score = torch.where(agree, pair_snr, float("-inf"))
    edge = score.amax(-1, keepdim=True) - 6.0
    near = ((pair_snr - cfg.thresh).abs() <= 4 * TOL) | (
        agree & ((score - edge).abs() <= 4 * TOL))
    return near.any(-1)


def scan_parts(what, a, b, occupied):
    """Channels [B] on which two sync scans from the same starts part
    (synced, k_sync or freq_error); none may be occupied."""
    import torch

    part = torch.zeros_like(occupied)
    for f in ("synced", "k_sync", "freq_error"):
        part |= a[f] != b[f]
    if bool((part & occupied).any()):
        raise AssertionError(f"{what}: the scans part on "
                             f"{int((part & occupied).sum())} occupied "
                             "channels")
    return part


def logged(detect, log):
    """`detect`, recording each call's CFO state, bins and squelch metric
    (the first window's power less noise) in `log`."""

    def run(x, down=False, ferr=None, want_f_index=True):
        d = detect(x, down, ferr, want_f_index=want_f_index)
        log.append((ferr[:, 0].clone(), d.value.clone(),
                    d.power[:, 0] - d.noise[:, 0]))
        return d

    return run


def first_parting(log_a, log_b, part, thresh):
    """Where two logged sync scans part: per channel of `part`, the CFO
    states' drift |ferr_a - ferr_b| (bins) at the first scan step whose
    bins or squelch decision differ.  -> (drifts [n], channels whose scan
    steps never differ, so that only the downchirp pair parts them)."""
    import torch

    f_a, v_a, s_a = (torch.stack(t) for t in zip(*log_a[:-1]))  # [steps, B]
    f_b, v_b, s_b = (torch.stack(t) for t in zip(*log_b[:-1]))
    squelch = (s_a < thresh) != (s_b < thresh)
    differs = ((v_a != v_b).any(-1) | squelch) & part
    first = torch.argmax(differs.to(torch.int32), dim=0)
    has = differs.any(0)
    drift = (f_a - f_b).abs().gather(0, first[None])[0]
    return drift[has], int((part & ~has).sum())


def hold_demod_on_bank(checks, bank, cfg, occupied):
    """Step 4c: kernels A, B, C against their plain versions on kernel D's
    config-3 bank [B, M], B and C from the plain route's starts, by the
    rules of step 3a.  Kernel B's scan runs kernel A's detect routine
    (csrc/detect.cuh): replayed over kernel A, it must give kernel B's
    outputs on every channel, with each step's detections held against
    the plain detector on the same windows and CFO state.  -> (channels
    whose decisions part, plain track outputs, plain found_pre)."""
    import torch
    from lora_tpu_torch.models import demodulator as dm
    from lora_tpu_torch.ops import cuda_demod, cuda_detect
    from lora_tpu_torch.ops import detect as det_ops

    N, mtu = cfg.N, cfg.mtu
    B, M = bank.shape
    W = M // N
    chk_a, chk_b, chk_c = checks["detect"], checks["track"], checks["payload"]
    _, ok = check_detect(chk_a, det_ops, cuda_detect,
                         bank[:, : W * N].reshape(B, W, N), False, None, False)
    coarse = dm._coarse_detect(bank, cfg, False)
    t_cand, t0, fp = dm._align_frame(*coarse, cfg, M)
    _, t0k, fpk = dm._align_frame(*dm._coarse_detect(bank, cfg, True), cfg, M)
    moved = (t0k != t0) | (fpk != fp)
    marginal = ~ok.all(-1) | coarse_marginal(*coarse, cfg)
    if bool((moved & ~marginal).any()):
        raise AssertionError("kernel A's coarse search moves a frame start "
                             "without a near tie")

    def kernel_step(x, down=False, ferr=None, want_f_index=True):
        return check_detect(chk_a, det_ops, cuda_detect, x, down, ferr,
                            want_f_index)[0]

    log_k, log_p = [], []
    trk = cuda_demod.track(bank, t0, cfg.sync, cfg.thresh, N)
    replay = cuda_demod.track_plain(bank, t0, cfg.sync, cfg.thresh, N,
                                    detect=logged(kernel_step, log_k))
    for f in ("synced", "k_sync", "freq_error"):
        chk_b.equal(f"{f} of the scan over kernel A", replay[f], trk[f])
    for f in ("fine_total", "power", "snr"):
        chk_b.close(f"{f} of the scan over kernel A", replay[f], trk[f])
    trp = cuda_demod.track_plain(bank, t0, cfg.sync, cfg.thresh, N,
                                 detect=logged(det_ops.dechirp_detect, log_p))
    part = scan_parts("kernel B", trk, trp, occupied)
    for f in ("fine_total", "power", "snr"):
        chk_b.close(f, trk[f], trp[f], mask=occupied)
    drift, late = first_parting(log_k, log_p, part, cfg.thresh)
    head, fine = dm._head(trp, cfg, t0, t_cand, fp, M)
    ds = head.consumed
    kc = cuda_demod.payload_detect(bank, ds, fine, mtu, N)
    pc = cuda_demod.payload_detect_plain(bank, ds, fine, mtu, N)
    ok = chk_c.values(kc[0], pc[0],
                      payload_spectra(det_ops, bank, ds, fine, N, mtu))
    chk_c.close("power", kc[1], pc[1], mask=ok)
    chk_c.close("noise", kc[2], pc[2], mask=ok)
    print(f"kernels A, B, C on kernel D's bank (B={B}, N={N}): ok, "
          f"{int(moved.sum())} frame starts moved, {chk_a.ties + chk_c.ties} "
          f"near-tie windows in all; kernel B equals the plain scan over "
          f"kernel A on every channel, each step held against the plain "
          f"detector on the same input.  The scans part on {int(part.sum())} "
          f"empty channels: {int((drift == 0).sum())} at a step with the "
          f"same CFO state, {int((drift > 0).sum())} after the states "
          f"drifted apart (at most "
          f"{float(drift.max()) if drift.numel() else 0.0:.3g} bins, median "
          f"{float(drift.median()) if drift.numel() else 0.0:.3g}), {late} "
          "in the downchirp pair only", flush=True)
    return part | moved, trp, fp


def outcome(api, dem, cfg):
    """(found [B] as a list, payloads [B]) of a demodulator result."""
    mtu = cfg.mtu
    found = dem.found.reshape(-1).tolist()
    return found, api.extract_payloads(api.decode(
        dem.symbols.reshape(-1, mtu), cfg))


def differing(what, a, b, occupied):
    """Channels whose found or payload differ between two outcomes; none
    may be occupied."""
    out = [i for i in range(len(a[0]))
           if a[0][i] != b[0][i] or a[1][i] != b[1][i]]
    if any(occupied[i] for i in out):
        raise AssertionError(f"{what}: {sum(occupied[i] for i in out)} "
                             "occupied channels differ in found or payload")
    return out


def config3(torch, dev, card, sync, checks, profile=False):
    """Step 4: the config-3 wideband bank.  -> (check, launches, ms)."""
    from lora_tpu_torch import api
    from lora_tpu_torch.ops import channelizer as chz
    from lora_tpu_torch.ops import cuda_channelize
    from lora_tpu_torch.ops import detect as det_ops

    cfg = config3_cfg()
    N, mtu = cfg.N, cfg.mtu
    S, K = C3_STREAMS, C3_K
    M = api.required_samples(cfg)
    L = 8
    hist = L * K - 1

    # ---- a. kernel D vs plain --------------------------------------------
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    chk_d = Check("channelize")
    for k, s, m in C3_PARITY:
        m = m or M
        x = awgn((s, k * m), 1.0, gen, dev)
        rel = {}
        for st in (awgn((s, L * k - 1), 1.0, gen, dev), None):
            yk, sk = chz.channelize(x, k, state=st)
            yp, sp = chz.channelize(x, k, state=st, impl="xla")
            rel[st is None] = chk_d.close_rel(f"K={k}", yk, yp, D_RTOL)
            if not torch.equal(sk, sp):
                raise AssertionError(f"channelize: new_state differs at "
                                     f"K={k}")
            del yk, yp, sk, sp
        print(f"kernel D parity K={k} S={s} M={m} (route "
              f"{cuda_channelize.route(k, L)}): max |y_D - y_plain| = "
              f"{rel[False]:.3g} of max |y_plain| with a state, "
              f"{rel[True]:.3g} with none; new_state equal", flush=True)
        del x, st
    sync()

    # ---- b. the path through the kernels ---------------------------------
    wide, payload = make_wideband(api, chz, cfg, S, K, C3_SIGMA, SEED + 11,
                                  dev)
    T = wide.shape[1]
    print(f"wideband: S={S} streams x K={K} channels, T={T} "
          f"({M} per channel), {S * K // 2} frames on even channels, "
          f"{wide.numel() * 8 / 1e9:.2f} GB complex64", flush=True)
    (dem, _), launches = count_launches(
        "channelized_demodulate(fused='auto')",
        lambda: api.channelized_demodulate(wide, K, cfg, fused="auto"),
        sync, ("channelize", "detect", "track", "payload"))
    if dem.found.shape != (S, K):
        raise AssertionError(f"found has shape {tuple(dem.found.shape)}")
    for f in ("power", "snr", "fine_freq"):
        if not bool(torch.isfinite(getattr(dem, f)).all()):
            raise AssertionError(f"non-finite {f}")
    lost = (~dem.found[:, 0::2]).sum().item()
    if lost:
        raise AssertionError(f"{lost} of {S * K // 2} frames not found")
    auto = outcome(api, dem, cfg)
    got = auto[1]
    want = payload.cpu().numpy()
    bad = [(s, k) for s in range(S) for k in range(0, K, 2)
           if got[s * K + k] != bytes(want[s, k // 2])]
    if bad:
        raise AssertionError(f"{len(bad)} of {S * K // 2} payloads not "
                             f"byte-exact: {bad[:20]}")
    print(f"path: {S * K // 2}/{S * K // 2} frames found and byte-exact; "
          f"{int(dem.found[:, 1::2].sum())} of {S * K // 2} empty channels "
          "report a frame", flush=True)

    # ---- c. against fused="off" ------------------------------------------
    ref, _ = api.channelized_demodulate(wide, K, cfg, fused="off")
    plain = outcome(api, ref, cfg)
    occupied = torch.zeros((S, K), dtype=torch.bool, device=dev)
    occupied[:, 0::2] = True
    occupied = occupied.reshape(-1)
    occ = occupied.tolist()
    sel = occupied.nonzero().reshape(-1)
    pick = lambda d, f: getattr(d, f).reshape(S * K, -1)[sel]
    routes = differing("the routes", auto, plain, occ)  # found and payloads
    for f in ("t_sync", "consumed", "freq_error"):
        if not torch.equal(pick(dem, f), pick(ref, f)):
            raise AssertionError(f"fused='auto' and 'off' differ in {f}")
    # the routes' banks: kernel D's (the path's) and the plain product's
    bank = chz.channelize(wide, K)[0].reshape(S * K, M)
    pbank = chz.channelize(wide, K, impl="xla")[0].reshape(S * K, M)
    rel = chk_d.close_rel("the path's bank", bank, pbank, D_RTOL)
    chk_sym = Check("symbols")
    ds = (pick(ref, "consumed") - pick(ref, "count") * N)[:, 0]
    chk_sym.values(pick(dem, "symbols"), pick(ref, "symbols"),
                   payload_spectra(det_ops, pbank[sel], ds,
                                   pick(ref, "fine_freq")[:, 0], N, mtu))
    print(f"routes, occupied channels: found, payloads, t_sync, consumed, "
          f"freq_error equal on {sel.numel()}; symbols equal but for "
          f"{chk_sym.ties} near-tie windows; the banks differ by {rel:.3g} "
          "of their max", flush=True)
    # An empty channel holds its neighbours' transition-band leakage (a
    # LoRa frame fills its channel and the bank is critically sampled):
    # partial chirps about 25 dB down, whose spectra sit at near ties.  The
    # routes part there in two steps: the demod kernels against their
    # plain versions on kernel D's bank, held decision by decision, and
    # kernel D's rounding under the plain route, set beside a control: the
    # plain route against itself with noise of that rounding's rms added.
    part_k, trp, fp = hold_demod_on_bank(checks, bank, cfg, occupied)
    n_empty = len(occ) - sum(occ)
    same_differ = (fp & trp["synced"]) != dem.found.reshape(-1)
    if bool((same_differ & ~part_k).any()):
        raise AssertionError("the demod kernels change found where their "
                             "decisions do not part")
    if int(same_differ.sum()) > SAME_DIFFER * n_empty:
        raise AssertionError(f"the demod kernels change found on "
                             f"{int(same_differ.sum())} empty channels")
    del trp
    sigma_d = float((bank - pbank).abs().square().mean().sqrt())
    plain_on = lambda x: outcome(api, api.demodulate(x, cfg, fused="off"),
                                 cfg)
    rounding = differing("kernel D's rounding", plain_on(bank), plain, occ)
    del bank
    g = torch.Generator(device=dev).manual_seed(SEED + 12)
    noisy = pbank + awgn(pbank.shape, sigma_d / math.sqrt(2), g, dev)
    del pbank
    control = differing("the control", plain_on(noisy), plain, occ)
    del noisy
    for i in range(len(occ)):
        if occ[i]:
            continue
        s, k = divmod(i, K)
        allowed = {None, b"", bytes(want[s, (k - 1) // 2]),
                   bytes(want[s, (k + 1) % K // 2])}
        if got[i] not in allowed or plain[1][i] not in allowed:
            raise AssertionError(f"empty channel {k} of stream {s} decodes "
                                 f"{got[i]!r} / {plain[1][i]!r}")
    for what, n in (("the routes differ", len(routes)),
                    ("kernel D's rounding changes the plain route",
                     len(rounding))):
        if n > EMPTY_DIFFER * n_empty:
            raise AssertionError(f"{what} on {n} of {n_empty} empty channels")
    print(f"routes, empty channels: {len(routes)} of {n_empty} differ in "
          f"found or payload (bound {EMPTY_DIFFER * n_empty:.0f}).  The demod "
          f"kernels on kernel D's bank change found on "
          f"{int(same_differ.sum())} (bound {SAME_DIFFER * n_empty:.0f}), "
          f"each where a decision parts; kernel D's rounding (rms "
          f"{sigma_d:.3g}) changes the plain route on {len(rounding)}; noise "
          f"of that rms on the plain bank changes it on {len(control)} "
          "(control).  None decodes a payload other than a neighbour's",
          flush=True)
    del ref

    # ---- d. times ---------------------------------------------------------
    xp = chz.prepended(wide, None, hist)
    ms = interleaved(lambda: cuda_channelize.filterbank(wide, K, L),
                     lambda: cuda_channelize.filterbank_plain(xp, K, L, M),
                     sync)
    print(f"time channelize: kernel {ms[0]:.3f} ms on (no history, block), "
          f"plain {ms[1]:.3f} ms on the concatenated stream (S={S}, K={K}, "
          f"M={M}) [{card}]", flush=True)
    del xp
    e2e = both_routes(
        lambda route: api.channelized_demodulate(wide, K, cfg, fused=route),
        sync)
    for route in ("auto", "off"):
        rate = S * T / (e2e[route] * 1e-3) / 1e6
        peak = peak_above(
            lambda: api.channelized_demodulate(wide, K, cfg, fused=route),
            sync)
        print(f"time channelized_demodulate fused={route!r}: "
              f"{e2e[route]:.3f} ms, {rate:.1f} wide Msamples/s, "
              f"{S * K} channels, peak {peak:.2f} GB above the "
              f"{wide.numel() * 8 / 1e9:.2f} GB input (S={S}, T={T}) "
              f"[{card}]", flush=True)
    if profile:
        device_breakdown(
            "channelized_demodulate(fused='auto')",
            lambda: api.channelized_demodulate(wide, K, cfg, fused="auto"),
            e2e["auto"], sync, top=12)
    # each sample in and out once; per output sample 4L flop for the FIR
    # and 5 log2 K for the K-point IDFT, the fewest a fast transform needs
    bound_d = bound(2 * S * K * M * 8,
                    S * K * M * (5 * math.log2(K) + 4 * L))
    return chk_d, launches, ms, bound_d


def windows_close(what, got, want, rtol=TAP_RTOL) -> float:
    """max |got - want| over each window's largest |want| must be <= rtol;
    returns it."""
    peak = want.abs().amax(-1, keepdim=True).clamp_min(1e-30)
    err = float(((got - want).abs() / peak).max())
    if not err <= rtol:
        raise AssertionError(f"{what} differs by {err} > {rtol} of its "
                             "window's largest value")
    return err


def routes_equal(torch, what, a, b, fields=("found", "symbols", "t_sync",
                                            "consumed", "freq_error")):
    for f in fields:
        if not torch.equal(getattr(a, f), getattr(b, f)):
            raise AssertionError(f"{what}: fused='auto' and 'off' differ in "
                                 f"{f}")


def byte_exact(api, what, dec, payload):
    """Every decoded packet equals its payload row; returns the count."""
    got = api.extract_payloads(dec)
    want = [bytes(p) for p in payload.cpu().numpy().tolist()]
    bad = [i for i in range(len(want)) if got[i] != want[i]]
    if bad:
        raise AssertionError(f"{what}: {len(bad)} of {len(want)} payloads "
                             f"not byte-exact: {bad[:20]}")
    return len(want)


def device_breakdown(what, fn, e2e_ms: float, sync, calls: int = 3,
                     top: int = 8):
    """With --profile: the device time of `calls` warm calls of fn by kernel
    (torch.profiler), per call, beside the path's CUDA-event time e2e_ms;
    what is left of that is the device's idle share."""
    from torch.autograd import DeviceType

    from lora_tpu_torch.utils import trace

    fn()
    sync()
    with trace.session() as prof:
        for _ in range(calls):
            fn()
        sync()
    rows = sorted(((e.self_device_time_total / 1e3 / calls, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and not trace.absorbing(e.key)), reverse=True)
    busy = sum(t for t, _ in rows)
    print(f"profile {what}: device busy {busy:.3f} ms of {e2e_ms:.3f} ms per "
          f"call ({100 * (1 - busy / e2e_ms):.0f}% idle), {len(rows)} kernels",
          flush=True)
    for t, key in rows[:top]:
        print(f"profile   {t:8.3f} ms  {key[:90]}", flush=True)


def receive_options(torch, dev, card, sync, checks, profile=False):
    """Step 5: debug taps (kernel E), soft-decision RX (kernel C's mag2
    output) and multi-frame tracking on the flagship bank; kernel B's and
    C's comparisons go into `checks`.  -> (kernel E's check, {path:
    launches} of the three paths, kernel E's (ms, plain ms), its library
    ms, its bound)."""
    from lora_tpu_torch import api
    from lora_tpu_torch.models import demodulator as dm
    from lora_tpu_torch.ops import cuda_demod
    from lora_tpu_torch.ops import shift as shift_ops
    from lora_tpu_torch.ops.tables import N_TRACK_WIN, TRACK_ROWS

    chk_b, chk_c = checks["track"], checks["payload"]
    cfg = flagship_cfg()
    N, mtu = cfg.N, cfg.mtu
    bank, payload = make_bank(api, cfg, B_FLAGSHIP, SIGMA, SEED, dev)
    B, T = bank.shape
    v, snr0, pwr = dm._coarse_detect(bank, cfg, True)
    t_cand, t0, found_pre = dm._align_frame(v, snr0, pwr, cfg, T)
    tr = cuda_demod.track(bank, t0, cfg.sync, cfg.thresh, N)
    head, fine = dm._head(tr, cfg, t0, t_cand, found_pre, T)
    ds = head.consumed

    # ---- a. kernel E vs plain, bit-equal ----------------------------------
    chk_e = Check("shift")
    gen = torch.Generator(device=dev).manual_seed(SEED + 20)
    g_track = shift_ops.gather_rows(bank, t0.long() // N, TRACK_ROWS, N)
    for r in (t0 % N, torch.randint(0, N, (B,), generator=gen, device=dev)):
        chk_e.equal("track geometry",
                    shift_ops.shift_windows(g_track, r, N_TRACK_WIN),
                    shift_ops.shift_windows_plain(g_track, r, N_TRACK_WIN))
    del g_track
    g = shift_ops.gather_rows(bank, ds.long() // N, mtu + 1, N)
    r = (ds % N).clone()
    r[:3] = torch.tensor([0, 1, N - 1], device=dev)
    odd = int((r % 2).sum())
    chk_e.equal("payload geometry", shift_ops.shift_windows(g, r, mtu),
                shift_ops.shift_windows_plain(g, r, mtu))
    # lead [B/2, 2]: the candidate axis of max_frames = 2
    chk_e.equal("lead [B, K]",
                shift_ops.shift_windows(g.reshape(B // 2, 2, mtu + 1, N),
                                        r.reshape(B // 2, 2), mtu),
                shift_ops.shift_windows_plain(g, r, mtu).reshape(
                    B // 2, 2, mtu, N))
    sync()
    print(f"kernel E parity: bit-equal to the plain version at the payload "
          f"geometry ([{B}, {mtu + 1}, {N}] rows, {odd} odd shifts, r = 0, 1, "
          f"{N - 1} among them), with a [B, K] lead, and at the track "
          f"geometry ([{B}, {TRACK_ROWS}, {N}] rows)", flush=True)
    ms_e = interleaved(lambda: shift_ops.shift_windows(g, r, mtu),
                       lambda: shift_ops.shift_windows_plain(g, r, mtu), sync)
    idx = torch.arange(mtu * N, device=dev) + r.long()[:, None]
    flat = g.reshape(B, (mtu + 1) * N)
    lib_e = timed(lambda: torch.take_along_dim(flat, idx, dim=1), sync)
    del idx, flat
    bound_e = bound(2 * B * mtu * N * 8 + B * 4, 0.0)
    print(f"time shift: kernel {ms_e[0]:.3f} ms, plain {ms_e[1]:.3f} ms, "
          f"torch.take_along_dim alone {lib_e:.3f} ms, bound "
          f"{bound_e['bound_ms']:.3f} ms by {bound_e['bound_by']} (B={B}, "
          f"mtu={mtu}, N={N}) [{card}]", flush=True)
    del g

    # ---- b. kernel C's mag2 output vs plain --------------------------------
    kc = cuda_demod.payload_detect(bank, ds, fine, mtu, N, want_mag2=True)
    pc = cuda_demod.payload_detect_plain(bank, ds, fine, mtu, N,
                                         want_mag2=True)
    ok = chk_c.values(kc[0], pc[0], lambda i: pc[3].reshape(-1, N)[i])
    chk_c.close("power", kc[1], pc[1], mask=ok)
    chk_c.close("noise", kc[2], pc[2], mask=ok)
    err = windows_close("kernel C's mag2", kc[3], pc[3])
    # value is the lowest bin of the largest mag2 the kernel wrote
    top = kc[3].amax(-1)
    at_value = torch.gather(kc[3], -1, kc[0].long()[..., None])[..., 0]
    first = (kc[3] == top[..., None]).to(torch.int8).argmax(-1)
    if not torch.equal(at_value, top) or not torch.equal(first, kc[0].long()):
        raise AssertionError("kernel C: value is not the lowest bin of the "
                             "largest mag2 it wrote")
    sync()
    print(f"kernel C mag2 parity: ok, within {err:.3g} of each window's "
          f"peak (bound {TAP_RTOL}), {chk_c.ties} near-tie windows in all; "
          "value is the lowest bin of the largest mag2 written", flush=True)
    del kc, pc, ok, top, at_value, first
    ms_c = interleaved(
        lambda: cuda_demod.payload_detect(bank, ds, fine, mtu, N,
                                          want_mag2=True),
        lambda: cuda_demod.payload_detect(bank, ds, fine, mtu, N), sync)
    bound_c2 = bound(B * mtu * (N * 12 + 12), B * mtu * window_flops(N, True))
    print(f"time payload with mag2: kernel {ms_c[0]:.3f} ms, without "
          f"{ms_c[1]:.3f} ms, bound with mag2 {bound_c2['bound_ms']:.3f} ms "
          f"by {bound_c2['bound_by']} (B={B}, mtu={mtu}, N={N}) [{card}]",
          flush=True)

    by_path = {}

    def drive(what, fn, expect, exactly=None):
        out, by_path[what] = count_launches(what, fn, sync, expect, exactly)
        return out

    # ---- c. debug taps ------------------------------------------------------
    dem = drive("demodulate(debug=True, fused='auto')",
                lambda: api.demodulate(bank, cfg, debug=True, fused="auto"),
                ("detect", "track", "shift"))
    ref = api.demodulate(bank, cfg, debug=True, fused="off")
    routes_equal(torch, "debug", dem, ref)
    if not torch.equal(dem.raw, ref.raw):
        raise AssertionError("debug: raw differs between the routes")
    e_dec = windows_close("debug: dec", dem.dec, ref.dec)
    e_m2 = windows_close("debug: fft_mag2", dem.fft_mag2, ref.fft_mag2)
    if not bool(dem.found.all()):
        raise AssertionError("debug: frames not found")
    n = byte_exact(api, "debug", api.decode(dem.symbols, cfg), payload)
    print(f"debug taps: {n}/{B} frames byte-exact; raw equal to "
          f"fused='off', dec within {e_dec:.3g} and fft_mag2 within "
          f"{e_m2:.3g} of each window's largest value; found, symbols, "
          "t_sync, consumed, freq_error equal", flush=True)
    del dem, ref
    fresh(torch)

    # ---- d. soft-decision RX --------------------------------------------------
    def soft(x, route):
        d = api.demodulate(x, cfg, spectra=True, fused=route)
        return d, api.decode_soft(d.fft_mag2, cfg)

    dem, dec = drive("demodulate(spectra=True, fused='auto') + decode_soft",
                     lambda: soft(bank, "auto"),
                     ("detect", "track", "payload", "decode"))
    ref, rdec = soft(bank, "off")
    routes_equal(torch, "soft", dem, ref)
    e_m2 = windows_close("soft: fft_mag2", dem.fft_mag2, ref.fft_mag2)
    if not torch.equal(dec.status, rdec.status):
        raise AssertionError("soft: statuses differ between the routes")
    if api.extract_payloads(dec) != api.extract_payloads(rdec):
        raise AssertionError("soft: payloads differ between the routes")
    n = byte_exact(api, "soft", dec, payload)
    print(f"soft RX: {n}/{B} frames byte-exact through decode_soft on both "
          f"routes, statuses equal; fft_mag2 within {e_m2:.3g} of each "
          "window's peak", flush=True)
    del dem, dec, ref, rdec
    noisy, npay = make_bank(api, cfg, B_NOISY, SIGMA_NOISY, SEED + 2, dev)
    want = [bytes(p) for p in npay.cpu().numpy().tolist()]
    counts = {}
    for route in ("auto", "off"):
        d, sdec = soft(noisy, route)
        hdec = api.decode(d.symbols, cfg)
        counts[route] = tuple(
            sum(g == w for g, w in zip(api.extract_payloads(x), want))
            for x in (sdec, hdec))
        guarded = api.guard_soft_status(sdec, hdec)
        print(f"reference noise point (sigma={SIGMA_NOISY}), fused={route!r}: "
              f"B={B_NOISY}, {int(d.found.sum())} found, soft decoding "
              f"recovers {counts[route][0]}, hard decoding "
              f"{counts[route][1]}; {int((guarded == api.SOFT_UNVERIFIED).sum())} "
              "soft results unverified", flush=True)
        if counts[route][0] < counts[route][1]:
            raise AssertionError("soft decoding recovers fewer frames than "
                                 "hard decoding")
    if counts["auto"] != counts["off"]:
        raise AssertionError(f"soft: the routes recover {counts}")
    del noisy, d, sdec, hdec

    # ---- f. times of the debug and soft paths (the bank is still here) ----
    ms_debug = both_routes(
        lambda route: api.demodulate(bank, cfg, debug=True, fused=route), sync)
    ms_soft = both_routes(lambda route: soft(bank, route), sync)
    spectra = api.demodulate(bank, cfg, spectra=True).fft_mag2
    ms_dec = timed(lambda: api.decode_soft(spectra, cfg), sync)
    del spectra
    for what, ms in (("demodulate(debug=True)", ms_debug),
                     ("demodulate(spectra=True) + decode_soft", ms_soft)):
        for route in ("auto", "off"):
            print(f"time {what} fused={route!r}: {ms[route]:.3f} ms "
                  f"(B={B}, T={T}) [{card}]", flush=True)
    for route in ("auto", "off"):
        peak = peak_above(
            lambda: api.demodulate(bank, cfg, debug=True, fused=route), sync)
        print(f"memory demodulate(debug=True) fused={route!r}: peak "
              f"{peak:.2f} GB above the {bank.numel() * 8 / 1e9:.2f} GB bank, "
              f"taps returned included (B={B}, T={T}) [{card}]", flush=True)
        fresh(torch)
    print(f"time decode_soft alone: {ms_dec:.3f} ms (spectra [{B}, {mtu}, "
          f"{N}]) [{card}]", flush=True)
    if profile:
        device_breakdown("demodulate(debug=True, fused='auto')",
                         lambda: api.demodulate(bank, cfg, debug=True),
                         ms_debug["auto"], sync)
        device_breakdown("demodulate(spectra=True) + decode_soft",
                         lambda: soft(bank, "auto"), ms_soft["auto"], sync)
    del bank
    fresh(torch)

    # ---- e. multi-frame tracking ----------------------------------------------
    halves = [make_bank(api, cfg, B, SIGMA, SEED + 21 + i, dev)
              for i in range(2)]
    two = torch.cat([h[0] for h in halves], dim=1)
    pay2 = torch.stack([h[1] for h in halves], dim=1)  # [B, 2, 32]
    del halves
    # kernels B and C against their plain versions with [B, 2] candidate
    # offsets (candidate m reads channel m // 2), by the rules of 3a
    T2 = two.shape[1]
    t_cand, t0, found_pre = dm._align_multi(
        *dm._coarse_detect(two, cfg, True), cfg, 2, T2)
    kb = cuda_demod.track(two, t0, cfg.sync, cfg.thresh, N)
    pb = cuda_demod.track_plain(two, t0, cfg.sync, cfg.thresh, N)
    for f in ("synced", "k_sync", "freq_error"):
        chk_b.equal(f"{f} with [B, 2] candidates", kb[f], pb[f])
    for f in ("fine_total", "power", "snr"):
        chk_b.close(f"{f} with [B, 2] candidates", kb[f], pb[f])
    scan2 = scan_windows(torch, two, t0, cfg)
    head, fine = dm._head(pb, cfg, t0, t_cand, found_pre, T2)
    ds = head.consumed
    if tuple(ds.shape) != (B, 2):
        raise AssertionError(f"multi-frame: data starts {tuple(ds.shape)}")
    del kb, pb
    kc = cuda_demod.payload_detect(two, ds, fine, mtu, N, want_mag2=True)
    pc = cuda_demod.payload_detect_plain(two, ds, fine, mtu, N,
                                         want_mag2=True)
    ties = chk_c.ties
    ok = chk_c.values(kc[0], pc[0], lambda i: pc[3].reshape(-1, N)[i])
    chk_c.close("power with [B, 2] candidates", kc[1], pc[1], mask=ok)
    chk_c.close("noise with [B, 2] candidates", kc[2], pc[2], mask=ok)
    err = windows_close("kernel C's mag2 with [B, 2] candidates", kc[3],
                        pc[3])
    sync()
    print(f"kernels B and C parity with [B, 2] candidates (B={B}, "
          f"T={T2}): ok; B's synced, k_sync, freq_error equal and "
          f"fine_total, power, snr within {TOL}, "
          f"{float(scan2[0].float().mean()):.2f} windows transformed a "
          f"candidate; C's values equal but for "
          f"{chk_c.ties - ties} near-tie windows, power and noise within "
          f"{TOL}, mag2 within {err:.3g} of each window's peak", flush=True)
    del kc, pc, ok, head, fine, ds, t0, t_cand, found_pre
    fresh(torch)
    dem = drive("demodulate(max_frames=2, fused='auto')",
                lambda: api.demodulate(two, cfg, max_frames=2, fused="auto"),
                ("detect", "track", "payload"), exactly=1)
    if dem.found.shape != (B, 2) or dem.symbols.shape != (B, 2, mtu):
        raise AssertionError(f"multi-frame: found {tuple(dem.found.shape)}, "
                             f"symbols {tuple(dem.symbols.shape)}")
    lost = int((~dem.found).sum())
    if lost:
        raise AssertionError(f"multi-frame: {lost} of {2 * B} frames not found")
    if not bool((dem.t_sync[:, 1] > dem.t_sync[:, 0]).all()):
        raise AssertionError("multi-frame: candidates not in time order")
    n = byte_exact(api, "multi-frame",
                   api.decode(dem.symbols.reshape(2 * B, mtu), cfg),
                   pay2.reshape(2 * B, -1))
    ref = api.demodulate(two, cfg, max_frames=2, fused="off")
    routes_equal(torch, "multi-frame", dem, ref)
    print(f"multi-frame: {n}/{2 * B} frames of {B} buffers (T={two.shape[1]}) "
          "found in time order and byte-exact; found, symbols, t_sync, "
          "consumed, freq_error equal to fused='off'; one launch of each "
          "of kernels A, B, C", flush=True)
    del dem, ref
    fresh(torch)
    ms_multi = both_routes(
        lambda route: api.demodulate(two, cfg, max_frames=2, fused=route),
        sync)
    for route in ("auto", "off"):
        rate = two.numel() / (ms_multi[route] * 1e-3) / 1e6
        print(f"time demodulate(max_frames=2) fused={route!r}: "
              f"{ms_multi[route]:.3f} ms, {rate:.1f} Msamples/s (B={B}, "
              f"T={two.shape[1]}) [{card}]", flush=True)
    if profile:
        device_breakdown("demodulate(max_frames=2, fused='auto')",
                         lambda: api.demodulate(two, cfg, max_frames=2),
                         ms_multi["auto"], sync)
    return chk_e, by_path, ms_e, lib_e, bound_e


def stream_bank(api, cfg, B: int, seed: int, dev):
    """B channel streams of STREAM_FRAMES frames each (32-byte payloads), made
    on the card: gaps in [0, 6N) plus, after a frame, its mtu overshoot (the
    demodulator consumes mtu symbols), one transmitter a channel with a CFO
    of u bins (|u| < 0.4), a random phase per frame, AWGN sigma SIGMA.  (A
    fractional CFO leaks the preamble's peak into its neighbours, which the
    coarse search reads as a lower SNR; with a CFO of its own each frame
    of a channel may lose to the next frame's preamble at the window's end
    by the 6 dB rule of the single-frame search, and both packages lose the
    same frames: tests/test_torch_stream.py::
    test_stream_cfo_per_frame_losses_match_jax.)
    -> (host complex64 [B, L], payloads [B, F, 32], frame starts [B, F],
    frame length)."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    F, N = STREAM_FRAMES, cfg.N
    payload = torch.randint(0, 256, (B * F, 32), generator=g, device=dev,
                            dtype=torch.int64).to(torch.uint8)
    frames = api.modulate(api.encode(payload, cfg), cfg)
    Lf = frames.shape[1]
    over = (cfg.mtu - cfg.num_symbols(32)) * N + N
    gaps = torch.randint(0, 6 * N, (B, F), generator=g, device=dev)
    gaps[:, 1:] += over
    starts = torch.cumsum(gaps, 1) + torch.arange(F, device=dev) * Lf
    L = int(starts[:, -1].max()) + Lf + 2 * N
    u = ((torch.rand((B, 1), generator=g, device=dev) * 2 - 1) * 0.4
         ).repeat_interleave(F, 0)
    phase = torch.rand((B * F, 1), generator=g, device=dev) * 6.2831855
    n = torch.arange(Lf, device=dev, dtype=torch.float32)
    frames = frames * torch.polar(torch.ones_like(phase),
                                  u * (6.2831855 / N) * n + phase)
    stream = awgn((B, L), SIGMA, g, dev)
    frames = frames.reshape(B, F, Lf)
    rows = torch.arange(B, device=dev)[:, None]
    for j in range(F):
        idx = starts[:, j : j + 1] + torch.arange(Lf, device=dev)
        stream[rows, idx] += frames[:, j]
    del frames
    return (stream.cpu().numpy(), payload.reshape(B, F, 32).cpu().numpy(),
            starts.cpu().numpy(), Lf)


def stream_frames_exact(what, frames, payload, starts, OK):
    """Every sent frame found once, decoded byte-exact, t_start within one
    sample of where it was placed; no other frame with status OK."""
    B, F = starts.shape
    good = {}
    for f in frames:
        if f.status == OK:
            good.setdefault(f.channel, []).append(f)
    extra, bad = 0, []
    for b in range(B):
        got = sorted(good.get(b, []), key=lambda f: f.t_start)
        for j in range(F):
            hit = [f for f in got if abs(f.t_start - int(starts[b, j])) <= 1]
            if len(hit) != 1 or hit[0].payload != bytes(payload[b, j]):
                bad.append((b, j))
        extra += len(got) - sum(
            1 for f in got
            if any(abs(f.t_start - int(s)) <= 1 for s in starts[b]))
    if bad or extra:
        raise AssertionError(f"{what}: {len(bad)} of {B * F} frames not "
                             f"found once byte-exact at their start "
                             f"({bad[:10]}), {extra} extra frames with "
                             "status OK")
    return B * F


def profile_once(what, fn, sync, wall_ms: float):
    """With --profile: one call of fn under torch.profiler: the device's
    busy time (kernels and copies) against wall_ms, the same path's wall
    time without the profiler (which slows the host several times), the
    idle share, and the time the host-to-device copies overlap kernels."""
    from torch.autograd import DeviceType

    from lora_tpu_torch.utils import trace

    sync()
    with trace.session() as prof:
        fn()
        sync()
    wall = wall_ms
    dev_ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA
              and not trace.absorbing(e.name)]
    busy = sum(e.time_range.elapsed_us() for e in dev_ev) / 1e3
    copies = [e.time_range for e in dev_ev if "HtoD" in e.name]
    kernels = [e.time_range for e in dev_ev if "Memcpy" not in e.name
               and "Memset" not in e.name]
    overlap = sum(max(0, min(c.end, k.end) - max(c.start, k.start))
                  for c in copies for k in kernels) / 1e3
    print(f"profile {what}: device busy {busy:.3f} ms of {wall:.3f} ms "
          f"({100 * (1 - busy / wall):.0f}% idle), host-to-device copies "
          f"{sum(c.elapsed_us() for c in copies) / 1e3:.3f} ms, of which "
          f"{overlap:.3f} ms overlap kernels", flush=True)


def streaming(torch, dev, card, sync, cfg, profile=False):
    """Step 6a: StreamDemodulator over STREAM_CHANNELS channel streams of
    host blocks.  -> {path: launches} of the pump run and of the decode of
    its frames."""
    import io

    from lora_tpu_torch import api
    from lora_tpu_torch.models.decoder import OK
    from lora_tpu_torch.runtime import StreamDemodulator, decode_frames

    B, blk = STREAM_CHANNELS, STREAM_BLOCK
    host, payload, starts, Lf = stream_bank(api, cfg, B, SEED + 40, dev)
    fresh(torch)
    L = host.shape[1]
    W = api.required_samples(cfg)
    seam = int((starts // blk != (starts + Lf - 1) // blk).sum())
    window = int(((starts < W) & (starts + Lf > W)).sum())
    if not seam or not window:
        raise AssertionError(f"streaming: {seam} frames cross a block seam, "
                             f"{window} the first window's end")
    print(f"stream: {B} channels x {L} samples ({host.nbytes / 1e9:.2f} GB "
          f"complex64 on the host), {STREAM_FRAMES} frames of {Lf} samples a "
          f"channel; blocks of {blk}; {seam} frames cross a block seam, "
          f"{window} the first window's end (W={W})", flush=True)
    blocks = lambda a, b: (host[:, i : min(i + blk, b)]
                           for i in range(a, b, blk))

    def drive(sd, pump, a=0, b=L, flush=True, step_ms=None):
        out = []
        if pump:
            out.extend(sd.pump(blocks(a, b)))
        else:
            for x in blocks(a, b):
                sd.feed(x)
                while sd.ready():  # each step timed on its own
                    sync()
                    t = time.perf_counter()
                    out.extend(sd.step())
                    sync()
                    step_ms.append((time.perf_counter() - t) * 1e3)
        if flush:
            out.extend(sd.flush())
        return out

    steps = []
    observe = lambda *a: steps.append(1)
    sync()
    base_mem = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    sd = StreamDemodulator(cfg, B, device=dev, observer=observe)
    ring_gb = sd._ring.buf.numel() * 8 / 1e9
    t = time.perf_counter()
    frames = drive(sd, True)
    sync()
    wall = time.perf_counter() - t
    peak = (torch.cuda.max_memory_allocated() - base_mem) / 1e9
    n_steps = len(steps)
    offsets = sd.offsets.copy()
    del sd
    fresh(torch)
    # the same pump again on a new stream, untimed, its kernels counted
    counted = []
    _, launches = count_launches(
        "StreamDemodulator.pump", lambda: drive(StreamDemodulator(
            cfg, B, device=dev, observer=lambda *a: counted.append(1)),
            True), sync, ("detect", "track", "payload"))
    fresh(torch)
    if len(counted) != n_steps or any(
            launches[k] != n_steps for k in ("detect", "track", "payload")):
        raise AssertionError(f"streaming: launches {launches} in "
                             f"{len(counted)} steps ({n_steps} timed)")
    if n_steps < 2:
        raise AssertionError(f"streaming: {n_steps} device steps")
    frames, dec_launches = count_launches(
        "decode_frames (pump)", lambda: decode_frames(frames, cfg, dev),
        sync, ("decode",), exactly=1)
    n = stream_frames_exact("pump", frames, payload, starts, OK)
    print(f"stream pump: {n}/{n} frames found once, byte-exact, t_start "
          f"within 1 sample; {len(frames)} frames reported, none extra OK; "
          f"{n_steps} steps, kernels A, B, C once a step", flush=True)
    print(f"time stream pump: {wall * 1e3:.3f} ms for {n_steps} steps, "
          f"flush included: ingest {B * L / wall / 1e6:.1f} Msamples/s ({B} x "
          f"{L} samples over the wall time); peak device memory {peak:.2f} "
          f"GB, the ring's {ring_gb:.2f} GB included [{card}]", flush=True)
    key = lambda f: (f.channel, f.t_start, f.data_start, f.freq_error,
                     f.payload, f.status)
    want = [key(f) for f in frames]
    if profile:
        profile_once("StreamDemodulator.pump",
                     lambda: drive(StreamDemodulator(cfg, B, device=dev),
                                   True), sync, wall * 1e3)
    fresh(torch)

    # the stream through feed and run, STREAM_RUN_PASSES times, each step
    # of run timed on its own (the flush's steps are not)
    step_ms, wall_run = [], []
    for _ in range(STREAM_RUN_PASSES):
        sd = StreamDemodulator(cfg, B, device=dev)
        t = time.perf_counter()
        run = decode_frames(drive(sd, False, step_ms=step_ms), cfg, dev)
        sync()
        wall_run.append((time.perf_counter() - t) * 1e3)
        if [key(f) for f in run] != want or not (sd.offsets == offsets).all():
            raise AssertionError("streaming: feed/run and pump differ")
        del sd, run
        fresh(torch)
    print(f"stream feed/run: the frames and read pointers of pump in each "
          f"of {STREAM_RUN_PASSES} passes; "
          f"{', '.join(f'{x:.3f}' for x in wall_run)} ms a pass; a step "
          f"(window gather, demodulate, one readback, the host's "
          f"decisions), {len(step_ms)} in order: "
          f"{', '.join(f'{x:.3f}' for x in step_ms)} ms; median "
          f"{sorted(step_ms)[len(step_ms) // 2]:.3f}, from {min(step_ms):.3f} "
          f"to {max(step_ms):.3f} [{card}]", flush=True)

    cut = (L // 2) // blk * blk
    first = StreamDemodulator(cfg, B, device=dev)
    part = drive(first, True, 0, cut, flush=False)
    buf = io.BytesIO()
    t = time.perf_counter()
    first.save_state(buf)
    nbytes = buf.tell()
    del first
    fresh(torch)
    buf.seek(0)
    second = StreamDemodulator(cfg, B, device=dev)
    second.load_state(buf)
    sync()
    t_ckpt = time.perf_counter() - t
    del buf
    part += drive(second, True, cut, L)
    part = decode_frames(part, cfg, dev)
    if [key(f) for f in part] != want or not (second.offsets
                                              == offsets).all():
        raise AssertionError("streaming: a save_state/load_state round trip "
                             "changed the frames")
    del second
    fresh(torch)
    print(f"stream checkpoint: save_state at sample {cut}, load_state into a "
          f"new demodulator: the same frames and pointers ({nbytes / 1e9:.2f} "
          f"GB, {t_ckpt * 1e3:.3f} ms round trip) [{card}]", flush=True)
    return {"StreamDemodulator.pump": launches,
            "decode_frames (pump)": dec_launches}


def stream_modes(torch, dev, card, sync, cfg) -> dict:
    """Step 6d: StreamDemodulator.pump over STREAM_MODES_CHANNELS streams
    with soft=True and with max_frames=3, each on both routes, captured
    and under disable_jit(): every frame found once and byte-exact, each
    run's frames equal to the other's of its route (every field, the soft
    confidence included) and the decisions equal between the routes;
    kernels A, B, C once a step on "auto", none on "off".
    -> {path: launches}."""
    from lora_tpu_torch import api
    from lora_tpu_torch.models.decoder import OK
    from lora_tpu_torch.runtime import StreamDemodulator, decode_frames
    from lora_tpu_torch.utils import jit

    B, blk = STREAM_MODES_CHANNELS, STREAM_BLOCK
    host, payload, starts, _ = stream_bank(api, cfg, B, SEED + 45, dev)
    fresh(torch)
    L = host.shape[1]
    by_path = {}
    decide = lambda f: (f.channel, f.t_start, f.data_start, f.freq_error,
                        f.payload, f.status)
    every = lambda f: (*decide(f), tuple(f.symbols.tolist()), f.snr,
                       f.power, f.confidence,
                       None if f.hard_symbols is None
                       else tuple(f.hard_symbols.tolist()))
    for mode in ({"soft": True}, {"max_frames": 3}):
        runs = {}
        for route in ("auto", "off"):
            for captured in (True, False):
                what = (f"StreamDemodulator.pump({mode}, fused={route!r}, "
                        f"{'captured' if captured else 'disable_jit'})")

                def drive(steps):
                    sd = StreamDemodulator(
                        cfg, B, device=dev, fused=route,
                        observer=lambda *a: steps.append(1), **mode)
                    with (contextlib.nullcontext() if captured
                          else jit.disable_jit()):
                        out = list(sd.pump(
                            host[:, i : min(i + blk, L)]
                            for i in range(0, L, blk)))
                        return out + sd.flush()

                steps, counted = [], []
                t = time.perf_counter()
                frames = drive(steps)
                sync()
                wall = time.perf_counter() - t
                # again untimed, its kernels counted
                _, by_path[what] = count_launches(
                    what, lambda: drive(counted), sync,
                    ("detect", "track", "payload") if route == "auto"
                    else ())
                if route == "auto" and not (by_path[what]["payload"]
                                            == len(counted) == len(steps)):
                    raise AssertionError(f"{what}: kernel C launched "
                                         f"{by_path[what]['payload']} times "
                                         f"in {len(counted)} steps")
                frames, by_path[f"decode_frames ({what})"] = count_launches(
                    f"decode_frames ({what})",
                    lambda: decode_frames(frames, cfg, dev), sync,
                    ("decode",))
                n = stream_frames_exact(what, frames, payload, starts, OK)
                runs[(route, captured)] = frames
                print(f"{what}: {n}/{n} frames found once, byte-exact; "
                      f"{len(steps)} steps in {wall * 1e3:.3f} ms, "
                      f"{B * L / wall / 1e6:.1f} Msamples/s [{card}]",
                      flush=True)
        for route in ("auto", "off"):
            a, b = ([every(f) for f in runs[(route, c)]] for c in (True,
                                                                    False))
            if a != b:
                raise AssertionError(f"stream {mode} {route}: the captured "
                                     "run's frames differ from disable_jit's")
        if ([decide(f) for f in runs[("auto", True)]]
                != [decide(f) for f in runs[("off", True)]]):
            raise AssertionError(f"stream {mode}: the routes' frames differ")
        print(f"stream {mode}: captured and disable_jit runs equal in every "
              "field on each route; the routes' frames equal in channel, "
              "t_start, data_start, freq_error, payload and status",
              flush=True)
    return by_path


def slab_bank(torch, dev, card, sync, cfg, profile=False):
    """Step 6b: demodulate_bank over a host bank of SLAB_CHANNELS channels
    in slabs of SLAB.  -> {kernel: launches}."""
    from lora_tpu_torch import api
    from lora_tpu_torch.runtime import demodulate_bank

    parts = []
    for i, s in enumerate(range(0, SLAB_CHANNELS, SLAB)):
        n = min(SLAB, SLAB_CHANNELS - s)
        bank, pay = make_bank(api, cfg, n, SIGMA, SEED + 50 + i, dev)
        parts.append((bank.real.cpu().numpy(), bank.imag.cpu().numpy(),
                      pay.cpu().numpy()))
        del bank
    re = np.concatenate([p[0] for p in parts])
    im = np.concatenate([p[1] for p in parts])
    payload = np.concatenate([p[2] for p in parts])
    del parts
    fresh(torch)
    B, T = re.shape
    n_slabs = -(-B // SLAB)
    gb = 2 * re.nbytes / 1e9
    print(f"slab: host bank of {B} channels x {T} samples ({gb:.2f} GB "
          f"planar float32), {n_slabs} slabs of {SLAB}", flush=True)
    dem, launches = count_launches(
        "demodulate_bank", lambda: demodulate_bank(re, im, cfg, SLAB,
                                                   device=dev),
        sync, ("detect", "track", "payload"), exactly=n_slabs)
    for i, s in enumerate(range(0, B, SLAB)):
        x = torch.complex(torch.as_tensor(re[s : s + SLAB], device=dev),
                          torch.as_tensor(im[s : s + SLAB], device=dev))
        one = api.demodulate(x, cfg)
        for f in ("symbols", "count", "found", "freq_error", "fine_freq",
                  "power", "snr", "t_sync", "consumed", "found_pre",
                  "t_candidate", "payload_complete"):
            if not torch.equal(getattr(dem, f)[s : s + SLAB],
                               getattr(one, f).cpu()):
                raise AssertionError(f"slab {i}: {f} differs from "
                                     "demodulate of the slab alone")
        del x, one
    got = api.extract_payloads(api.decode(dem.symbols, cfg, device=dev))
    bad = [i for i in range(B) if got[i] != bytes(payload[i])]
    if bad:
        raise AssertionError(f"slab: {len(bad)} of {B} payloads not "
                             f"byte-exact: {bad[:20]}")
    times = []
    for _ in range(3):
        sync()
        t = time.perf_counter()
        demodulate_bank(re, im, cfg, SLAB, device=dev)
        sync()
        times.append((time.perf_counter() - t) * 1e3)
    times.sort()
    print(f"slab: every field bit-equal to demodulate of each slab alone, "
          f"{B}/{B} frames byte-exact", flush=True)
    print(f"time demodulate_bank: {times[1]:.3f} ms per bank of {B} "
          f"(median of 3: {', '.join(f'{x:.3f}' for x in times)}), "
          f"{B * T / (times[1] * 1e-3) / 1e6:.1f} Msamples/s [{card}]",
          flush=True)
    if profile:
        profile_once("demodulate_bank",
                     lambda: demodulate_bank(re, im, cfg, SLAB, device=dev),
                     sync, times[1])
    return launches


def replayed_stream(torch, path, dev, chunk, chk_d, K=1, ratio=1.0,
                    channel=0, dc_block=False):
    """The channel stream replay_file feeds its demodulator, rebuilt from
    the file by the same steps and chunks.  At an integer ratio K, kernel D
    is held on each chunk against filterbank_plain with the history that
    replay_file carries across the chunk seams (within D_RTOL, new states
    equal).  -> complex64 [n] on dev."""
    from lora_tpu_torch.ops import channelizer as chz
    from lora_tpu_torch.ops import cplx, cuda_channelize
    from lora_tpu_torch.ops import dcblock as dcb
    from lora_tpu_torch.ops import resample as rs
    from lora_tpu_torch.runtime import iqio

    parts, state, dstate, rstate, rel = [], None, None, None, 0.0
    with open(path, "rb") as f:
        while raw := f.read(chunk * 8):
            x = cplx.from_planar(*iqio.convert(raw, "cf32"), dev)
            if dc_block:
                x, dstate = dcb.dcblock(x, state=dstate)
            if K > 1:
                x = x[: x.shape[-1] // K * K]
                yk, sk = chz.channelize(x, K, state=state)
                yp, sp = chz.channelize(x, K, state=state, impl="xla")
                what = f"replay chunk {len(parts)} at K={K}"
                rel = max(rel, chk_d.close_rel(what, yk, yp, D_RTOL))
                if not torch.equal(sk, sp):
                    raise AssertionError(f"channelize: new_state differs in "
                                         f"{what}")
                state = sk
                parts.append(yk[channel])
            else:
                y, rstate = rs.resample_stream(x, ratio, rstate)
                parts.append(y)
    if K > 1:
        print(f"kernel D parity on the replay's {len(parts)} chunks (K={K}, "
              f"route {cuda_channelize.route(K, 8)}, the history carried "
              f"across each seam): max |y_D - y_plain| = {rel:.3g} of max "
              f"|y_plain|; new_state equal", flush=True)
    return torch.cat(parts)


def replay_windows_equal(torch, api, what, stream, steps, cfg):
    """Kernels A, B, C at the replay's shape [1, W]: each window a replay
    step demodulated (its offset before the step, the flush's zeros past
    the stream) through fused='auto' and 'off'.  The kernels' fields equal
    the replay's own step result, and the routes agree on every field the
    stream's decisions read (t_candidate where a preamble was seen and no
    frame found)."""
    W = api.required_samples(cfg)
    padded = torch.nn.functional.pad(stream, (0, W))
    off = 0
    for k, (own, after) in enumerate(steps):
        win = padded[off : off + W][None]
        a = api.demodulate(win, cfg, fused="auto")
        o = api.demodulate(win, cfg, fused="off")
        for f in DECIDE:
            if not torch.equal(getattr(a, f).cpu(), own[f]):
                raise AssertionError(f"{what}: step {k} (offset {off}): the "
                                     f"window rebuilt from the file gives "
                                     f"another {f} than the replay's step")
        fields = DECIDE[:-1] + (DECIDE[-1:] if bool(a.found_pre[0])
                                and not bool(a.found[0]) else ())
        routes_equal(torch, f"{what} step {k} (offset {off})", a, o, fields)
        off = int(after[0])
    print(f"{what}: kernels A, B, C at [1, {W}] on the replay's {len(steps)} "
          f"windows: the replay's own step results, and equal to fused='off' "
          f"in {', '.join(DECIDE[:-1])} (t_candidate where a preamble was "
          f"seen and no frame found)", flush=True)


def replay(torch, dev, card, sync, cfg, chk_d, profile=False):
    """Step 6c: capture files written with the port's tx path, replayed on
    the card.  -> {path: {kernel: launches}}."""
    import tempfile

    from lora_tpu_torch import api, cli
    from lora_tpu_torch.hw.capture import replay_file
    from lora_tpu_torch.models.decoder import OK
    from lora_tpu_torch.ops import channelizer as chz
    from lora_tpu_torch.ops import resample as rs
    from lora_tpu_torch.runtime import iqio

    g = np.random.default_rng(SEED + 60)
    by_path = {}
    rate = 125e3

    def observer(steps):
        # each step's result and the read pointer after it
        return lambda dem, frames, offsets: steps.append((
            {f: getattr(dem, f).cpu() for f in DECIDE}, offsets))
    with tempfile.TemporaryDirectory() as tmp:

        def write(name, x):
            path = os.path.join(tmp, name)
            x = x.cpu()
            with open(path, "wb") as f:
                f.write(iqio.interleave_cf32(x.real.numpy(),
                                             x.imag.numpy()).tobytes())
            return path

        def one_frame(what, frames, payload):
            ok = [f for f in frames if f.status == OK]
            if len(ok) != 1 or ok[0].payload != payload:
                raise AssertionError(f"{what}: decoded {[f.payload for f in ok]}")
            return ok[0]

        # ---- 1. integer ratio: kernel D, with the DC blocker ------------
        payload = bytes(g.integers(0, 256, 32).tolist())
        body = cli.tx_samples(payload, cfg, dev)
        nb = torch.complex(torch.as_tensor(body[0::2]),
                           torch.as_tensor(body[1::2])).to(dev)
        nb = torch.nn.functional.pad(nb, (3000, 4 * cfg.N))
        wide = chz.upconvert(nb, REPLAY_K, REPLAY_CHANNEL) + (0.5 - 0.25j)
        path = write("k8.cf32", wide)
        what = f"replay_file(K={REPLAY_K})"
        steps = []
        frames, by_path[what] = count_launches(
            what, lambda: replay_file(
                path, "cf32", cfg, capture_rate=REPLAY_K * rate,
                channel_rate=rate, channel=REPLAY_CHANNEL, dc_block=True,
                chunk=REPLAY_CHUNK_K, observer=observer(steps), device=dev),
            sync, ("channelize", "detect", "track", "payload", "decode"))
        f = one_frame(what, frames, payload)
        seam = REPLAY_CHUNK_K // REPLAY_K  # chunk seams, at the channel rate
        end = 3000 + body.shape[0] // 2
        print(f"{what}: {wide.shape[0]} capture samples with a DC offset, "
              f"frame on channel {REPLAY_CHANNEL} (channel samples 3000 to "
              f"{end}, over the chunk seam at {end // seam * seam}) "
              f"byte-exact at t_start {f.t_start}, chunks of "
              f"{REPLAY_CHUNK_K}", flush=True)
        if 3000 // seam == end // seam:
            raise AssertionError(f"{what}: the frame crosses no chunk seam")
        stream = replayed_stream(torch, path, dev, REPLAY_CHUNK_K, chk_d,
                                 K=REPLAY_K, channel=REPLAY_CHANNEL,
                                 dc_block=True)
        replay_windows_equal(torch, api, what, stream, steps, cfg)
        del stream

        # ---- 2. fractional ratio: the resampler; a frame over the seam ----
        payload = bytes(g.integers(0, 256, 32).tolist())
        body = cli.tx_samples(payload, cfg, dev)
        fr = torch.complex(torch.as_tensor(body[0::2]),
                           torch.as_tensor(body[1::2])).to(dev)
        seam = int(REPLAY_CHUNK / REPLAY_RATIO)  # the chunk seam, channel rate
        m0 = seam - fr.shape[0] // 2
        nb = torch.nn.functional.pad(fr, (m0, 4 * cfg.N))
        wide = rs.resample(nb, 1.0 / REPLAY_RATIO)
        full = rs.resample(wide, REPLAY_RATIO)
        state, parts = None, []
        for a in range(0, wide.shape[0], REPLAY_CHUNK):
            y, state = rs.resample_stream(wide[a : a + REPLAY_CHUNK],
                                          REPLAY_RATIO, state)
            parts.append(y)
        chunked = torch.cat(parts)
        n = min(chunked.shape[0], full.shape[0])
        if n < full.shape[0] - 8 or not torch.equal(chunked[:n], full[:n]):
            raise AssertionError("resample_stream chunked differs from "
                                 "resample on the card")
        print(f"resampler on the card: chunks of {REPLAY_CHUNK} bit-equal to "
              f"the whole ({n} outputs of {wide.shape[0]} inputs, ratio "
              f"{REPLAY_RATIO})", flush=True)
        path = write("frac.cf32", wide)
        what = f"replay_file(ratio={REPLAY_RATIO})"
        steps = []
        frames, by_path[what] = count_launches(
            what, lambda: replay_file(
                path, "cf32", cfg, capture_rate=REPLAY_RATIO * rate,
                channel_rate=rate, observer=observer(steps), device=dev),
            sync, ("resample", "detect", "track", "payload", "decode"))
        f = one_frame(what, frames, payload)
        print(f"{what}: {wide.shape[0]} capture samples, the frame "
              f"(channel samples {m0} to {m0 + fr.shape[0]}) over the chunk "
              f"seam at {seam}, byte-exact at t_start {f.t_start}",
              flush=True)
        stream = replayed_stream(torch, path, dev, REPLAY_CHUNK, chk_d,
                                 ratio=REPLAY_RATIO)
        replay_windows_equal(torch, api, what, stream, steps, cfg)
    return by_path


def step6(torch, dev, card, sync, checks, profile=False):
    """Step 6: streaming, slab and replay on the flagship config."""
    cfg = flagship_cfg()
    by_path = streaming(torch, dev, card, sync, cfg, profile)
    fresh(torch)
    by_path.update(stream_modes(torch, dev, card, sync, cfg))
    fresh(torch)
    by_path["demodulate_bank"] = slab_bank(torch, dev, card, sync, cfg,
                                           profile)
    fresh(torch)
    by_path.update(replay(torch, dev, card, sync, cfg, checks["channelize"],
                          profile))
    return by_path


# ---------------------------------------------------------------------------
# step 7: the multi-device paths on ranks that share the card
# ---------------------------------------------------------------------------

S7_RUNS = 3
S7_TIMEOUT = 600.0
S7_SFS = (7, 8, 9, 10, 11, 12)
S7_PATTERNS = 9  # step 7b's placements of a channel's frames (stream_plan)
MEAN_RTOL = 1e-5  # 7a: sharded means against the whole bank's (float32 sums)
# the collectives of lora_tpu_torch.parallel.comm, by the name each is
# printed under; while S7_COMM["log"] is a list (the counted run of a path)
# each call over a process group appends (op, bytes, ms) to it
S7_OPS = {"shift": "all_to_all_single (shift)",
          "all_to_all": "all_to_all_single", "all_gather": "all_gather",
          "all_reduce_sum": "all_reduce"}
S7_COMM = {"log": None}


def time_collectives(torch, dist):
    """Wrap comm.py's collectives in this rank (halo.py, channelize.py and
    mesh.py call them through the module): while S7_COMM["log"] is a list,
    each call over a process group appends its op, the bytes that reached
    this rank from the others (from the shape of the tensor it was given)
    and its host ms between two device synchronisations."""
    from lora_tpu_torch.parallel import comm

    def moved(name, x, group, by=1):
        n = dist.get_world_size(group)
        nbytes = x.numel() * x.element_size()
        if name == "shift":
            return nbytes if n > 1 and by % n else 0
        if name == "all_to_all":
            return nbytes // n * (n - 1)
        return nbytes * (n - 1)

    def wrap(name, fn):
        def call(x, group, *args):
            log = S7_COMM["log"]
            if log is None or group is None:
                return fn(x, group, *args)
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(x, group, *args)
            torch.cuda.synchronize()
            log.append((S7_OPS[name], moved(name, x, group, *args),
                        (time.perf_counter() - t) * 1e3))
            return out
        return call

    for name in S7_OPS:
        setattr(comm, name, wrap(name, getattr(comm, name)))


def s7_record(torch, mesh, launches, ms, log):
    """What a rank sends back of one path: its launches, the path's ms, the
    bytes and ms of each collective (summed by op) and its peak device
    memory."""
    traffic = {}
    for op, nbytes, t in log:
        n, b, s = traffic.get(op, (0, 0, 0.0))
        traffic[op] = (n + 1, b + nbytes, s + t)
    return {"launches": launches, "ms": ms, "traffic": traffic,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def s7_drive(torch, dist, what, mesh, path, sync, expect, runs=S7_RUNS):
    """One path on every rank: the counted and checked run (launches from 0,
    every collective logged with a sync on each side), then `runs` timed
    runs, each between two barriers (the median wall ms)."""
    fresh(torch)
    torch.cuda.reset_peak_memory_stats()
    log = S7_COMM["log"] = []
    dist.barrier()
    out, launches = count_launches(f"{what} [rank {mesh.rank}]", path, sync,
                                   expect)
    S7_COMM["log"] = None
    times = []
    for _ in range(runs):
        dist.barrier()
        t = time.perf_counter()
        path()
        sync()
        dist.barrier()
        times.append((time.perf_counter() - t) * 1e3)
    times.sort()
    return out, s7_record(torch, mesh, launches, times[len(times) // 2], log)


def s7_alone(dist, mesh, fn, sync, runs=None):
    """Rank 0's ms of the single-process call while the others wait: the
    CUDA-event median of timed(), or with `runs` the host-clock median of
    that many synchronised calls after a warm-up."""
    ms = None
    if mesh.rank == 0:
        if runs is None:
            ms = timed(fn, sync)
        else:
            fn()
            sync()
            times = []
            for _ in range(runs):
                t = time.perf_counter()
                fn()
                sync()
                times.append((time.perf_counter() - t) * 1e3)
            ms = sorted(times)[runs // 2]
    dist.barrier()
    return ms


def s7_fields_equal(torch, what, got, want) -> bool:
    """Every field of a gathered result against the single-process one:
    integers and flags equal, floats within TOL; True when the floats are
    bit-equal too."""
    bit = True
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if b is None:
            continue
        if a is None or a.shape != b.shape:
            raise AssertionError(f"{what}: field {f.name} missing or of "
                                 f"another shape")
        if b.is_floating_point():
            d = float((a - b).abs().max()) if b.numel() else 0.0
            if not d <= TOL:
                raise AssertionError(f"{what}: {f.name} differs by {d}")
            bit = bit and torch.equal(a, b)
        elif not torch.equal(a, b):
            raise AssertionError(f"{what}: {f.name} differs in "
                                 f"{int((a != b).sum())} places")
    return bit


def collectives_taken(torch, dist, dev) -> dict:
    """Which collectives this group's backend takes for CUDA tensors:
    comm.py's three (all_to_all_single with split sizes, the list
    all_gather, all_reduce of float64) must; all_gather_into_tensor is
    probed beside them and only reported."""
    n, r = dist.get_world_size(), dist.get_rank()
    x = torch.arange(8, dtype=torch.uint8, device=dev) + 16 * r
    taken = {}
    send = [0] * n
    recv = [0] * n
    send[(r + 1) % n] = 8
    recv[(r - 1) % n] = 8
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, recv, send)
    taken["all_to_all_single"] = out.tolist() == (
        torch.arange(8) + 16 * ((r - 1) % n)).tolist()
    outs = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(outs, x)
    taken["all_gather"] = [int(o[0]) for o in outs] == [16 * i
                                                       for i in range(n)]
    y = torch.ones(2, dtype=torch.float64, device=dev)
    dist.all_reduce(y)
    taken["all_reduce"] = float(y[0]) == n
    if not all(taken.values()):
        raise AssertionError(f"{dist.get_backend()}: {taken}")
    try:  # reported only: the port does not use it
        flat = torch.empty(8 * n, dtype=torch.uint8, device=dev)
        dist.all_gather_into_tensor(flat, x)
        taken["all_gather_into_tensor"] = True
    except (RuntimeError, ValueError) as e:
        taken["all_gather_into_tensor"] = f"refused: {str(e)[:80]}"
    return taken


def s7a(torch, dist, dev, sync) -> dict:
    """7a: shard_demodulate of the flagship bank, decode and
    aggregate_metrics under the sharding, the gathered results against
    rank 0's whole-bank api.demodulate."""
    from lora_tpu_torch import api
    from lora_tpu_torch.parallel import (aggregate_metrics, channel_sharding,
                                         gather_result, make_mesh,
                                         shard_demodulate)

    mesh = make_mesh(device=dev)
    cfg = flagship_cfg()
    bank, payload = make_bank(api, cfg, B_FLAGSHIP, SIGMA, SEED, dev)
    x = bank[channel_sharding(mesh, B_FLAGSHIP)]
    if mesh.rank:
        x = x.clone()
        del bank

    def path():
        dem = shard_demodulate(x, cfg, mesh)
        dec = api.decode(dem.symbols, cfg)
        m = aggregate_metrics(dem, dec.status, mesh)
        return gather_result(dem, mesh), gather_result(dec, mesh), m

    (g, gdec, m), rec = s7_drive(torch, dist, "7a shard_demodulate", mesh,
                                 path, sync, ("detect", "track", "payload",
                                              "decode"))
    rec["rows"] = x.shape[0]
    single = None
    if mesh.rank == 0:
        whole = api.demodulate(bank, cfg)
        wdec = api.decode(whole.symbols, cfg)
        wm = api.aggregate_metrics(whole, wdec.status)
        rec["bit_equal"] = s7_fields_equal(torch, "7a", g, whole)
        if not torch.equal(gdec.status, wdec.status):
            raise AssertionError("7a: decode statuses differ")
        rec["exact"] = byte_exact(api, "7a", gdec, payload)
        for k in ("frames", "synced", "symbols", "decoded_ok", "dropped"):
            if int(m[k]) != int(wm[k]):
                raise AssertionError(f"7a: aggregate {k} {int(m[k])} != "
                                     f"{int(wm[k])}")
        rec["metrics"] = {k: float(v) for k, v in m.items()}
        rec["mean_diff"] = 0.0
        for k in m:
            if k.startswith("mean_"):
                d = abs(float(m[k]) - float(wm[k]))
                if not d <= MEAN_RTOL * max(1.0, abs(float(wm[k]))):
                    raise AssertionError(f"7a: aggregate {k} {float(m[k])} "
                                         f"!= {float(wm[k])} beyond float32 "
                                         "summation order")
                rec["mean_diff"] = max(rec["mean_diff"], d)

        def single():
            d = api.demodulate(bank, cfg)
            api.aggregate_metrics(d, api.decode(d.symbols, cfg).status)
    rec["single_ms"] = s7_alone(dist, mesh, single, sync)
    return {"7a shard_demodulate": rec}


def stream_plan(T_local: int, FL: int, N: int):
    """Step 7b's placements (tests/test_parallel.py:69-78 at the flagship
    t_local, and two frames in shard 0's region): frame starts of
    pattern p, a channel b taking pattern b % S7_PATTERNS."""
    return [[0], [T_local - FL // 3], [T_local - 2], [T_local // 2],
            [T_local + 5], [max(0, T_local - FL + 64)], [37],
            [T_local - 8 * N], [64, 64 + FL + 500]]


def s7b(torch, dist, dev, sync) -> dict:
    """7b: demodulate_stream over time = 2 with max_frames = 2: every frame
    claimed once by its owner, t_sync global within 1, byte-exact."""
    from lora_tpu_torch import api
    from lora_tpu_torch.parallel import (demodulate_stream, gather_result,
                                         make_mesh)

    mesh = make_mesh(time=2, device=dev)
    cfg = flagship_cfg()
    N, B = cfg.N, B_FLAGSHIP
    t_local = api.required_samples(cfg) + 4 * N
    T = 2 * t_local
    g = torch.Generator(device=dev).manual_seed(SEED)
    u = (torch.rand((B, 1), generator=g, device=dev) * 2 - 1) * 0.4
    bank = awgn((B, T), SIGMA, g, dev)
    FL = api.modulate(api.encode(torch.zeros((1, 32), dtype=torch.uint8,
                                             device=dev), cfg), cfg).shape[1]
    plan = stream_plan(t_local, FL, N)
    n = torch.arange(FL, device=dev, dtype=torch.float32)
    sent = []  # (channel, start, payload)
    for p, starts in enumerate(plan):
        rows = torch.arange(p, B, S7_PATTERNS, device=dev)
        for o in starts:
            pay = torch.randint(0, 256, (rows.numel(), 32), generator=g,
                                device=dev, dtype=torch.int64).to(torch.uint8)
            fr = api.modulate(api.encode(pay, cfg), cfg)
            phase = torch.rand((rows.numel(), 1), generator=g,
                               device=dev) * 6.2831855
            ang = u[rows] * (6.2831855 / N) * n + phase
            bank[rows, o : o + FL] += fr * torch.polar(torch.ones_like(ang),
                                                       ang)
            sent += [(int(b), o, bytes(q)) for b, q in
                     zip(rows.tolist(), pay.cpu().numpy().tolist())]
    t = mesh.coord["time"]
    x = bank[:, t * t_local : (t + 1) * t_local].contiguous()
    if mesh.rank:
        del bank

    def path():
        return gather_result(demodulate_stream(x, cfg, mesh, max_frames=2),
                             mesh, "time")

    dem, rec = s7_drive(torch, dist, "7b demodulate_stream", mesh, path, sync,
                        ("detect", "track", "payload"))
    rec["frames"] = len(sent)
    single = None
    if mesh.rank == 0:
        found = dem.found.cpu().numpy()  # [time, B, 2]
        t_sync = dem.t_sync.cpu().numpy()
        pay = api.extract_payloads(api.decode(
            dem.symbols.reshape(-1, cfg.mtu), cfg))
        bad = []
        for b, o, q in sent:
            hit = [(s, k) for s in range(2) for k in range(2)
                   if found[s, b, k] and abs(int(t_sync[s, b, k])
                                             - (o + 10 * N)) <= 1]
            if (len(hit) != 1 or hit[0][0] != o // t_local
                    or pay[(hit[0][0] * B + b) * 2 + hit[0][1]] != q):
                bad.append((b, o, hit))
        extra = int(found.sum()) - len(sent)
        if bad or extra:
            raise AssertionError(f"7b: {len(bad)} of {len(sent)} frames not "
                                 f"claimed once by their owner byte-exact "
                                 f"({bad[:5]}), {extra} extra claims")
        rec["straddling"] = sum(1 for _, o, _ in sent
                                if o < t_local < o + FL)
        whole = api.demodulate(bank, cfg, max_frames=2)
        wf, wt = whole.found.cpu().numpy(), whole.t_sync.cpu().numpy()
        rec["same_as_single"] = sum(
            sorted(wt[b][wf[b]].tolist()) == sorted(
                t_sync[:, b][found[:, b]].tolist()) for b in range(B))
        if rec["same_as_single"] != B:
            raise AssertionError(f"7b: the stream's t_sync equals one "
                                 f"demodulate(max_frames=2) of the global "
                                 f"bank on {rec['same_as_single']} of {B} "
                                 "channels")
        single = lambda: api.demodulate(bank, cfg, max_frames=2)
    rec["single_ms"] = s7_alone(dist, mesh, single, sync)
    return {"7b demodulate_stream": rec}


def s7c(torch, dist, dev, sync) -> dict:
    """7c: channelize_stream of the config-3 bank (kernel D on each time
    shard with the neighbour's tail as history, the corner turn), then
    shard_demodulate of the 16,384 channels."""
    from lora_tpu_torch import api
    from lora_tpu_torch.ops import channelizer as chz
    from lora_tpu_torch.parallel import (channelize_stream, gather_result,
                                         make_mesh, shard_demodulate)

    n_time = dist.get_world_size()
    mesh = make_mesh(time=n_time, device=dev)
    cfg = config3_cfg()
    K = C3_K
    wide, payload = make_wideband(api, chz, cfg, C3_STREAMS, K, C3_SIGMA,
                                  SEED, dev)
    S, T = wide.shape
    t = mesh.coord["time"]
    t_local = T // n_time
    x = wide[:, t * t_local : (t + 1) * t_local].contiguous()

    def path():
        y = channelize_stream(x, K, mesh)
        k, M = y.shape[1:]
        dem = shard_demodulate(y.reshape(S * k, M), cfg, mesh)
        dem = dataclasses.replace(dem, **{
            f.name: getattr(dem, f.name).reshape(S, k, *getattr(
                dem, f.name).shape[1:])
            for f in dataclasses.fields(dem)
            if getattr(dem, f.name) is not None})
        return y, gather_result(dem, mesh, ("channel", "time"))

    (y, g), rec = s7_drive(torch, dist, "7c channelize_stream", mesh, path,
                           sync, ("channelize", "detect", "track",
                                  "payload"))
    # kernel D across the seam against one channelize of the whole stream
    ref = chz.channelize(wide, K)[0][:, t * y.shape[1] : (t + 1) * y.shape[1]]
    rec["d_bit_equal"] = bool(torch.equal(y, ref))
    rec["d_err"] = float((y - ref).abs().max()) / float(ref.abs().max())
    if not rec["d_err"] <= D_RTOL:
        raise AssertionError(f"7c: kernel D across the seam differs by "
                             f"{rec['d_err']} of the largest output")
    del y, ref
    single = None
    if mesh.rank == 0:
        whole, _ = api.channelized_demodulate(wide, K, cfg)
        occ = torch.zeros((S, K), dtype=torch.bool, device=dev)
        occ[:, 0::2] = True
        for f in ("found", "count", "symbols", "t_sync", "consumed",
                  "freq_error"):
            a, b = getattr(g, f), getattr(whole, f)
            if not torch.equal(a[occ], b[occ]):
                raise AssertionError(f"7c: {f} differs on occupied channels")
        rec["empty_differ"] = int((
            (g.found != whole.found) | (g.symbols != whole.symbols).any(-1)
            | (g.t_sync != whole.t_sync))[~occ].sum())
        dec = api.decode(g.symbols[:, 0::2].reshape(-1, cfg.mtu), cfg)
        rec["exact"] = byte_exact(api, "7c", dec, payload.reshape(-1, 16))
        single = lambda: api.channelized_demodulate(wide, K, cfg)
    rec["single_ms"] = s7_alone(dist, mesh, single, sync)
    return {"7c channelize_stream + shard_demodulate": rec}


def s7_routes(torch, api, what, bank, cfg, spectra) -> float:
    """Kernels A, B and C (C with mag2 when spectra) at one bank's shapes
    against their plain versions: demodulate(fused='auto') and 'off' equal
    in every decision field (t_candidate where a preamble was seen and no
    frame found), fine_freq, power and snr within TOL, fft_mag2 within
    TAP_RTOL of each window's peak.  -> the largest float difference."""
    a = api.demodulate(bank, cfg, spectra=spectra, fused="auto")
    o = api.demodulate(bank, cfg, spectra=spectra, fused="off")
    routes_equal(torch, what, a, o, DECIDE[:-1])
    pre = a.found_pre & ~a.found
    if not torch.equal(a.t_candidate[pre], o.t_candidate[pre]):
        raise AssertionError(f"{what}: fused='auto' and 'off' differ in "
                             "t_candidate")
    d = 0.0
    for f in ("fine_freq", "power", "snr"):
        d = max(d, float((getattr(a, f) - getattr(o, f)).abs().max()))
    if not d <= TOL:
        raise AssertionError(f"{what}: fine_freq, power or snr differ by {d}")
    if spectra:
        windows_close(f"{what}: fft_mag2", a.fft_mag2, o.fft_mag2)
    return d


def s7d(torch, dist, dev, sync) -> dict:
    """7d: ChannelDispatcher over 4096 channels, SF7 to SF12 round robin,
    hard and soft, against the dispatcher without a mesh; rank 0 first
    holds kernels A, B and C (with and without mag2) against the plain
    route on each SF group's bank."""
    from lora_tpu_torch import api
    from lora_tpu_torch.parallel import ChannelDispatcher, make_mesh
    from lora_tpu_torch import LoRaConfig

    mesh = make_mesh(device=dev)
    cfgs = []
    for sf in S7_SFS:
        c = LoRaConfig(sf=sf, cr="4/8", ampl=1.0)
        cfgs.append(c.replace(mtu=c.num_symbols(32) + 4))
    B = B_FLAGSHIP
    configs = [cfgs[ch % len(cfgs)] for ch in range(B)]
    streams, payloads = [None] * B, [None] * B
    routes = {}
    for i, c in enumerate(cfgs):
        members = list(range(i, B, len(cfgs)))
        bank, pay = make_bank(api, c, len(members), SIGMA, SEED + i, dev)
        if mesh.rank == 0:
            routes[f"SF{c.sf}"] = [
                s7_routes(torch, api, f"7d SF{c.sf} routes ({m})", bank, c,
                          m == "soft") for m in ("hard", "soft")]
            fresh(torch)
        host = bank.cpu().numpy()
        for j, ch in enumerate(members):
            streams[ch] = host[j]
            payloads[ch] = bytes(pay[j].cpu().numpy().tolist())
        del bank
    out = {}
    for soft in (False, True):
        what = f"7d ChannelDispatcher {'soft' if soft else 'hard'}"
        disp = ChannelDispatcher(configs, soft=soft, mesh=mesh)
        res, rec = s7_drive(torch, dist, what, mesh,
                            lambda: disp.run(streams), sync,
                            ("detect", "track", "payload", "decode"), runs=1)
        alone = None
        if mesh.rank == 0:
            bad = [r.channel for r in res if not (
                r.found and r.status == 0 and r.payload == payloads[r.channel])]
            if bad:
                raise AssertionError(f"{what}: {len(bad)} of {B} channels "
                                     f"not found byte-exact: {bad[:10]}")
            single = ChannelDispatcher(configs, soft=soft, device=dev)
            ref = single.run(streams)
            for a, b in zip(res, ref):
                if (a.found, a.status, a.payload) != (b.found, b.status,
                                                      b.payload) or \
                        not np.array_equal(a.symbols, b.symbols):
                    raise AssertionError(f"{what}: channel {a.channel} "
                                         "differs from the single process")
            rec["exact"] = B
            alone = lambda: single.run(streams)
        rec["single_ms"] = s7_alone(dist, mesh, alone, sync, runs=1)
        if mesh.rank == 0:
            rec["routes_float_diff"] = {k: v[soft] for k, v in routes.items()}
        out[what] = rec
    return out


def rank7(steps) -> dict:
    """One rank of step 7: the collectives its backend takes, then each
    sub-step of `steps` in turn.  -> {path: record}."""
    import torch
    import torch.distributed as dist

    dev = torch.device("cuda", torch.cuda.current_device())
    sync = torch.cuda.synchronize
    out = {"collectives": collectives_taken(torch, dist, dev)}
    time_collectives(torch, dist)
    fns = {"7a": s7a, "7b": s7b, "7c": s7c, "7d": s7d}
    for s in steps:
        out.update(fns[s](torch, dist, dev, sync))
    return out


def step7(torch, card) -> dict:
    """Step 7: the multi-device paths (lora_tpu_torch.parallel) on ranks
    spawned by parallel.dryrun.launch: two ranks on this one card over
    gloo (7a to 7d), then one rank over NCCL (7a, 7c).  Prints each path's
    time beside the single-process call, the collectives' bytes and time
    and each rank's peak device memory -> {path: launches summed over the
    ranks}."""
    import functools

    from lora_tpu_torch.parallel import dryrun

    by_path = {}
    for world, backend, steps in ((2, "gloo", ("7a", "7b", "7c", "7d")),
                                  (1, "nccl", ("7a", "7c"))):
        t = time.perf_counter()
        ranks = dryrun.launch(world, functools.partial(rank7, steps),
                              backend=backend, device="cuda",
                              timeout=S7_TIMEOUT)
        who = f"{world} {backend} rank{'s' if world > 1 else ''}"
        print(f"step 7 on {who} ({time.perf_counter() - t:.1f} s with the "
              f"ranks' start); collectives taken for CUDA tensors: "
              f"{ranks[0]['collectives']}", flush=True)
        for path in ranks[0]:
            if path == "collectives":
                continue
            recs = [r[path] for r in ranks]
            r0 = recs[0]
            launches = {k: sum(r["launches"][k] for r in recs)
                        for k in r0["launches"]}
            by_path[f"{path} ({who})"] = launches
            traffic = "; ".join(
                f"{op} x{n}: {b / 1e6:.3f} MB in {s:.3f} ms"
                for op, (n, b, s) in r0["traffic"].items()) or "none"
            extra = {k: v for k, v in r0.items() if k not in (
                "launches", "ms", "traffic", "peak_gb", "single_ms")}
            peaks = ", ".join("%.2f" % r["peak_gb"] for r in recs)
            print(f"time {path} ({who}): {r0['ms']:.3f} ms (every rank, "
                  f"barrier to barrier) against the single-process call "
                  f"{r0['single_ms']:.3f} ms on the same bank; rank 0's "
                  f"collectives: {traffic}; peak device memory by rank: "
                  f"{peaks} GB; launches by rank: "
                  f"{[r['launches'] for r in recs]}; {extra} [{card}]",
                  flush=True)
    print("step 7: the ranks share one card's SMs and gloo moves CUDA "
          "tensors through the host, so these times measure the "
          "collectives' cost, not scaling; NCCL runs one rank here (it "
          "refuses two ranks on one device)", flush=True)
    return by_path


# ---------------------------------------------------------------------------
# step 8: the benchmark, the channelizer's bf16 route, the trace hook
# ---------------------------------------------------------------------------

# kernel D's bf16 route against filterbank_fir_plain: the FIR
# output may differ by a float32 step (fused multiply-adds) and then its
# bfloat16 rounding by one bfloat16 step, and the tensor cores sum the
# products in another order (tests/test_torch_channelizer.py, BF16_FIR_*):
# at least BF16_SHARE of the samples within BF16_RTOL of the peak, every
# sample within BF16_MAX_RTOL of it
BF16_RTOL = 1e-5
BF16_SHARE = 0.99
BF16_MAX_RTOL = 1e-2
# lora_tpu's bar for its bf16 kernels, absolute, on unit-variance noise
# (tests/test_pallas_channelize.py:62-65)
BF16_ATOL = 3e-2
# (K, streams): the config-3 bank's width, then other widths as step 4a
# gives them (192 no power of two, 1024 its matrix streamed from L2)
BF16_PARITY = ((C3_K, C3_STREAMS), (16, 16), (192, 16), (1024, 2))


def bf16_close(torch, chk, what, got, want) -> tuple:
    """Kernel D's bf16 route against its plain version by the BF16_* bars.
    -> (share within BF16_RTOL of the peak, max |diff| over the peak,
    whether bit-equal)."""
    d = (got - want).abs()
    peak = float(want.abs().max())
    err = float(d.max())
    chk.max_abs_err = max(chk.max_abs_err, err)
    share = float((d <= BF16_RTOL * peak).float().mean())
    if share < BF16_SHARE or err > BF16_MAX_RTOL * peak:
        raise AssertionError(f"{chk.name}: {what}: {share:.6f} of the "
                             f"samples within {BF16_RTOL} of the peak (bar "
                             f"{BF16_SHARE}), max {err / peak:.3g} of it "
                             f"(bar {BF16_MAX_RTOL})")
    return share, err / peak, torch.equal(got, want)


def s8a_bench(torch, sync) -> dict:
    """8a: lora_tpu_torch.benchmarks --validate at its full rungs, each
    rung's run (warm-up and calls) counted under the profiler, then run
    again outside it for the record's times: kernels A, B, C on the "auto"
    rungs, none on the "off" rung.  Prints the record; the check must be
    ok.  -> {rung path: launches}."""
    import contextlib
    import io

    from lora_tpu_torch import benchmarks

    by_rung = {}
    run_rung = benchmarks.run_rung

    def counted(x, cfg, fused, calls):
        what = f"benchmarks sf{cfg.sf}-{fused}/B{x.shape[0]}"
        expect = () if fused == "off" else ("detect", "track", "payload")
        _, by_rung[what] = count_launches(
            what, lambda: run_rung(x, cfg, fused, calls), sync, expect)
        return run_rung(x, cfg, fused, calls)

    out, err = io.StringIO(), io.StringIO()
    benchmarks.run_rung = counted
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = benchmarks.main(["--validate"])
    finally:
        benchmarks.run_rung = run_rung
        print(out.getvalue() + err.getvalue(), end="", flush=True)
    rec = json.loads(out.getvalue().strip().splitlines()[-1])
    checks = [json.loads(line) for line in err.getvalue().splitlines()
              if line.startswith("{")]
    tags = {f"sf{sf}-{m}/B{b}" for sf, m, b in benchmarks.RUNGS}
    if rc != 0 or not rec["value"] > 0 or set(rec["rungs"]) != tags:
        raise AssertionError(f"benchmarks: rc {rc}, value {rec['value']}, "
                             f"rungs {sorted(rec['rungs'])}")
    if checks != [{"check": "bf16_vs_f32_decisions", "ok": True}]:
        raise AssertionError(f"benchmarks --validate: {checks}")
    for tag, r in rec["rungs"].items():
        print(f"benchmark rung {tag}: median {r['median_ms']:.3f} ms (min "
              f"{r['min_ms']:.3f}, max {r['max_ms']:.3f}, {r['calls']} "
              f"calls), {r['msamples_s']:.1f} Msamples/s [{rec['device']}]",
              flush=True)
    return by_rung


def s8b_bf16(torch, dev, card, sync, profile=False):
    """8b: kernel D's bf16 route on config 3.  -> (its check, {path:
    launches}, {ms, plain_ms, f32_ms, matmul_idft_ms}, its bound and
    route)."""
    from lora_tpu_torch import api
    from lora_tpu_torch.ops import channelizer as chz
    from lora_tpu_torch.ops import cuda_channelize as cc

    cfg = config3_cfg()
    S, K, L = C3_STREAMS, C3_K, 8
    M = api.required_samples(cfg)
    gen = torch.Generator(device=dev).manual_seed(SEED + 20)
    chk = Check("channelize bf16")
    for k, n in BF16_PARITY:
        x = awgn((n, k * M), 1.0, gen, dev)
        for st in (awgn((n, L * k - 1), 1.0, gen, dev), None):
            yk = cc.filterbank(x, k, L, st, bf16=True)
            xp = chz.prepended(x, st, L * k - 1)
            share, rel, same = bf16_close(
                torch, chk, f"K={k}", yk,
                cc.filterbank_fir_plain(xp, k, L, M))
            del xp
            y32 = cc.filterbank(x, k, L, st)
            far = float(torch.view_as_real(yk - y32).abs().max())
            if not far < BF16_ATOL:
                raise AssertionError(f"channelize bf16: {far} from the "
                                     f"float32 kernel at K={k}")
            print(f"kernel D bf16 parity K={k} S={n} M={M} (route "
                  f"{cc.route(k, L, True)}), with "
                  f"{'a state' if st is not None else 'none'}: "
                  f"{share:.6f} of the samples within {BF16_RTOL} of the "
                  f"plain bf16 version's peak, max {rel:.3g} of it, "
                  f"bit-equal: {same}; {far:.3g} from the float32 kernel "
                  f"(bar {BF16_ATOL})", flush=True)
            del yk, y32
        del x, st
    sync()

    wide, payload = make_wideband(api, chz, cfg, S, K, C3_SIGMA, SEED + 11,
                                  dev)
    (dem, _), launches = count_launches(
        "channelized_demodulate(fused='bf16')",
        lambda: api.channelized_demodulate(wide, K, cfg, fused="bf16"),
        sync, ("channelize", "detect", "track", "payload"))
    lost = int((~dem.found[:, 0::2]).sum())
    if lost:
        raise AssertionError(f"bf16 path: {lost} of {S * K // 2} frames "
                             "not found")
    got = outcome(api, dem, cfg)[1]
    want = payload.cpu().numpy()
    bad = [(s, k) for s in range(S) for k in range(0, K, 2)
           if got[s * K + k] != bytes(want[s, k // 2])]
    if bad:
        raise AssertionError(f"bf16 path: {len(bad)} of {S * K // 2} "
                             f"payloads not byte-exact: {bad[:20]}")
    auto, _ = api.channelized_demodulate(wide, K, cfg, fused="auto")
    # occupied channels whose decision differs from fused="auto", by field;
    # the symbols of the frame (16-byte payload) apart from the mtu's last
    # two windows, which hold noise
    occ = lambda t: t[:, 0::2].reshape(S * K // 2, -1)
    differ = {f: int((occ(getattr(dem, f)) != occ(getattr(auto, f)))
                     .any(-1).sum()) for f in DECIDE}
    frame = cfg.num_symbols(16)
    differ["symbols of the frame"] = int(
        (occ(dem.symbols)[:, :frame] != occ(auto.symbols)[:, :frame])
        .any(-1).sum())
    print(f"bf16 path: {S * K // 2}/{S * K // 2} frames found and "
          f"byte-exact; occupied channels whose field differs from "
          f"fused='auto': {differ}", flush=True)
    del dem, auto

    xp = chz.prepended(wide, None, L * K - 1)
    ms = dict(zip(("ms", "plain_ms"), interleaved(
        lambda: cc.filterbank(wide, K, L, bf16=True),
        lambda: cc.filterbank_fir_plain(xp, K, L, M), sync)))
    del xp
    ms["f32_ms"] = timed(lambda: cc.filterbank(wide, K, L), sync)
    print(f"time channelize bf16: kernel {ms['ms']:.3f} ms (route "
          f"{cc.route(K, L, True)}), plain {ms['plain_ms']:.3f} ms; the "
          f"float32 kernel {ms['f32_ms']:.3f} ms (route {cc.route(K, L)}) "
          f"(S={S}, K={K}, M={M}) [{card}]", flush=True)
    # the yardstick of the IDFT alone: one library product of the same
    # shape and types as route 3's (bf16 [S*M, 2K] x [2K, 2K]); not a
    # criterion, and not on any path of the port
    ub = torch.randn((S * M, 2 * K), generator=gen, device=dev).to(
        torch.bfloat16)
    wbig = torch.randn((2 * K, 2 * K), generator=gen, device=dev).to(
        torch.bfloat16)
    ms["matmul_idft_ms"] = timed(lambda: torch.matmul(ub, wbig), sync)
    del ub, wbig
    print(f"time torch.matmul bf16 [{S * M}, {2 * K}] x [{2 * K}, {2 * K}] "
          f"(the IDFT part alone, a yardstick): {ms['matmul_idft_ms']:.3f} "
          f"ms [{card}]", flush=True)
    e2e = {}
    for mode in ("bf16", "auto", "auto", "bf16"):
        t_ms = timed(lambda: api.channelized_demodulate(wide, K, cfg,
                                                        fused=mode), sync)
        e2e[mode] = min(e2e.get(mode, t_ms), t_ms)
    T = wide.shape[1]
    for mode in ("bf16", "auto"):
        print(f"time channelized_demodulate fused={mode!r}: "
              f"{e2e[mode]:.3f} ms, {S * T / (e2e[mode] * 1e-3) / 1e6:.1f} "
              f"wide Msamples/s (S={S}, T={T}) [{card}]", flush=True)
    if profile:
        device_breakdown(
            "channelized_demodulate(fused='bf16')",
            lambda: api.channelized_demodulate(wide, K, cfg, fused="bf16"),
            e2e["bf16"], sync, top=12)
    # each sample in and out once; per output sample 4L float32 flop of FIR
    # and 8K of IDFT on bfloat16 operands (a dense K x K product, the
    # tensor cores' type): bound by its bytes
    bnd = bound(2 * S * K * M * 8, S * K * M * 4 * L, S * K * M * 8 * K)
    bnd["channelize_route"] = cc.route(K, L, True)
    return chk, {"channelized_demodulate(fused='bf16')": launches}, ms, bnd


def s8c_trace(torch, dev, sync) -> dict:
    """8c: utils.trace.profile around one flagship demodulate(fused="auto")
    writes a Chrome trace that names kernels A, B and C once each, at the
    end of a run of minutes, where torch.profiler alone drops a session's
    first device records (kernel A among them: tools/torch_kernel_probe.py
    --trace; utils/trace.py); frame_events gives one event per channel.
    -> {path: launches}."""
    import tempfile

    from lora_tpu_torch import api
    from lora_tpu_torch.utils import trace

    cfg = flagship_cfg()
    bank, _ = make_bank(api, cfg, B_FLAGSHIP, SIGMA, SEED, dev)
    api.demodulate(bank, cfg, fused="auto")  # warm: the trace holds one call
    sync()
    what = "demodulate(fused='auto') under utils.trace.profile"
    with tempfile.TemporaryDirectory() as tmp:
        with trace.profile(tmp):
            dem = api.demodulate(bank, cfg, fused="auto")
            sync()
        files = [f for f in os.listdir(tmp) if f.endswith(".pt.trace.json")]
        if len(files) != 1:
            raise AssertionError(f"trace: {files} in the trace directory")
        path = os.path.join(tmp, files[0])
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        size = os.path.getsize(path)
    names = [str(e.get("name", "")) for e in events
             if e.get("cat") == "kernel"]
    # the written trace is the record the launches are counted from
    launches = trace.kernel_launches(names)
    check_launches(what, launches, ("detect", "track", "payload"), exactly=1)
    named = {k: launches[k] for k in ("detect", "track", "payload")}
    absorbed = sum(trace.ABSORB_KERNEL in n for n in names)
    ev = trace.frame_events(dem, cfg)
    if [e["channel"] for e in ev] != list(range(B_FLAGSHIP)):
        raise AssertionError(f"frame_events: {len(ev)} events for "
                             f"{B_FLAGSHIP} channels")
    print(f"trace of one call: {size} bytes, {len(names)} device kernels, "
          f"of them detect/track/payload {named}; {absorbed} of the "
          f"{trace.ABSORB} launches that open the session kept; "
          f"frame_events: "
          f"{len(ev)} events, one a channel; first {ev[0]}", flush=True)
    return {what: launches}


def step8(torch, dev, card, sync, profile=False):
    """Step 8: 8a the benchmark, 8b kernel D's bf16 route and the bf16
    path on config 3, 8c the trace hook.  -> (kernel D bf16's check, ms and
    bound; {path: launches})."""
    t = time.perf_counter()
    by_path = s8a_bench(torch, sync)
    fresh(torch)
    chk, paths, ms, bnd = s8b_bf16(torch, dev, card, sync, profile)
    by_path.update(paths)
    fresh(torch)
    by_path.update(s8c_trace(torch, dev, sync))
    fresh(torch)
    print(f"step 8: {time.perf_counter() - t:.1f} s", flush=True)
    return chk, ms, bnd, by_path


# ---------------------------------------------------------------------------
# step 9: the tools and the examples (lora_tpu_torch.tools, .examples)
# ---------------------------------------------------------------------------

# 9a: the 60 points lora_tpu measured against the reference FSM, at each
# row's n (2,720 frames), hard and soft, rebuilt draw for draw
S9_FRAMES = 2720
S9_DIFFER = 13         # frames whose route decisions may differ: 0.5%
S9_REF_HARD = 1102     # the reference FSM's committed total
S9_JAX_HARD = 1207     # lora_tpu's committed totals on the identical banks
S9_JAX_SOFT = 1968
S9_JAX_SLACK = 27      # 1% of the frames
S9_BANK_THREADS = 6
# 9b: bench_e2e's full pass (config 5), then 2 slabs in the other modes
E2E_CHANNELS = 10240
E2E_SLAB = 2048
E2E_PAYLOAD = 32
# 9c: bench_soft and bench_decode
S9_B = 2048
S9_REPS = 7
# 9d: lora_simulation's piped lines and the messages that must come back
SIM_LINES = ["/noise 1.0", "hello from the card", "/sf 8",
             "back at sf8", "/show"]
SIM_MESSAGES = ["hello from the card", "back at sf8"]

S9_ABC = ("detect", "track", "payload")
# a path that builds its own bank on the card (encode, then kernel F)
S9_TX = (*S9_ABC, "modulate")


def s9a_sensitivity(torch, dev, sync) -> dict:
    """9a: every point of docs/sensitivity_vs_reference.json (through
    run_sensitivity_campaign.point_specs, at each row's n), each bank built
    once (bench_sensitivity.make_bank, in a thread pool ahead of the card,
    its encode captured beside the main thread's programs: utils/jit.py
    makes captures take turns) and given to fused="auto" (kernels A, B, C; C with mag2) and to
    fused="off", hard and soft.  Gates: the routes' found, hard- and
    soft-recovered flags differ on at most S9_DIFFER frames; the kernels'
    hard total at least the reference's S9_REF_HARD and no point more than
    one frame below its recovered_ref; hard and soft totals within
    S9_JAX_SLACK of lora_tpu's.  -> {path: launches}."""
    from concurrent.futures import ThreadPoolExecutor

    from lora_tpu_torch.tools import bench_sensitivity as bs
    from lora_tpu_torch.tools import run_sensitivity_campaign as camp

    rows = bs.committed_rows()
    specs = camp.point_specs(rows)
    if sum(s["n"] for s in specs) != S9_FRAMES:
        raise AssertionError(f"9a: {len(specs)} points of "
                             f"{sum(s['n'] for s in specs)} frames")
    cfgs = {(s["sf"], s["cr"]): bs.point_cfg(s["sf"], s["cr"])
            for s in specs}
    cfg_of = lambda s: cfgs[(s["sf"], s["cr"])]
    banks = []

    def route(s, bank, fused):
        return bs.point(cfg_of(s), s["noise"], s["n"], rotate=s["rotate"],
                        soft=True, fused=fused, device=dev, bank=bank)

    def auto_route():
        # the pool starts inside the counted run, so that the banks' kernel
        # F launches all fall in it (every bank is done by its end)
        with ThreadPoolExecutor(S9_BANK_THREADS) as pool:
            made = [pool.submit(bs.make_bank, cfg_of(s), s["noise"], s["n"],
                                bs.SEED, s["rotate"], dev) for s in specs]
            out = []
            for s, m in zip(specs, made):
                banks.append(m.result())
                out.append(route(s, banks[-1], "auto"))
        return out

    what = f"9a sensitivity, {len(specs)} points hard and soft"
    auto, la = count_launches(f"{what}, fused='auto'", auto_route, sync,
                              (*S9_TX, "decode"))
    off, lo = count_launches(
        f"{what}, fused='off'",
        lambda: [route(s, b, "off") for s, b in zip(specs, banks)], sync,
        ("decode",))
    differ, below = 0, []
    tot = {"hard": 0, "soft": 0, "off_hard": 0, "off_soft": 0, "ref": 0}
    for s, (row, pf), (orow, opf) in zip(specs, auto, off):
        for i in range(s["n"]):
            parts = [k for k in ("found", "hard", "soft")
                     if bool(pf[k][i]) != bool(opf[k][i])]
            if parts:
                differ += 1
                print(f"9a routes differ: SF{s['sf']} {s['cr']} noise "
                      f"{s['noise']} rotate {s['rotate']} n {s['n']} frame "
                      f"{i}: {parts}", flush=True)
        tot["hard"] += row["recovered_ours"]
        tot["soft"] += row["recovered_soft"]
        tot["off_hard"] += orow["recovered_ours"]
        tot["off_soft"] += orow["recovered_soft"]
        tot["ref"] += row["recovered_ref"]
        if row["recovered_ours"] < row["recovered_ref"] - 1:
            below.append(row)
        print(f"9a SF{s['sf']} {s['cr']} noise {s['noise']} rotate "
              f"{row.get('rotate', 0)} n {s['n']}: kernels hard "
              f"{row['recovered_ours']} soft {row['recovered_soft']}; plain "
              f"{orow['recovered_ours']} / {orow['recovered_soft']}; "
              f"lora_tpu {row['recovered_jax']} / "
              f"{row['recovered_jax_soft']} (delta "
              f"{row['recovered_ours'] - row['recovered_jax']:+d} / "
              f"{row['recovered_soft'] - row['recovered_jax_soft']:+d}); "
              f"reference {row['recovered_ref']} (delta "
              f"{row['recovered_ours'] - row['recovered_ref']:+d}) "
              f"[{row['ref_source']}]", flush=True)
    jax_h = sum(r["recovered_ours"] for r in rows)
    jax_s = sum(r["recovered_soft"] for r in rows)
    tally = {what: camp.tally([r for r, _ in auto], ours, theirs)
             for what, ours, theirs in (
                 ("reference", "recovered_ours", "recovered_ref"),
                 ("lora_tpu hard", "recovered_ours", "recovered_jax"),
                 ("lora_tpu soft", "recovered_soft", "recovered_jax_soft"))}
    print(f"9a totals over {S9_FRAMES} frames: kernels hard {tot['hard']} "
          f"soft {tot['soft']}, plain hard {tot['off_hard']} soft "
          f"{tot['off_soft']}; lora_tpu hard {jax_h} soft {jax_s}; "
          f"reference {tot['ref']}; frames whose routes differ {differ} "
          f"(bar {S9_DIFFER}); better/equal/worse {tally}", flush=True)
    if differ > S9_DIFFER:
        raise AssertionError(f"9a: the routes differ on {differ} frames")
    if tot["hard"] < S9_REF_HARD or below:
        raise AssertionError(f"9a: hard total {tot['hard']} against the "
                             f"reference's {S9_REF_HARD}; points more than "
                             f"one frame below it: {below}")
    if (abs(tot["hard"] - S9_JAX_HARD) > S9_JAX_SLACK
            or abs(tot["soft"] - S9_JAX_SOFT) > S9_JAX_SLACK):
        raise AssertionError(f"9a: totals {tot['hard']} / {tot['soft']} "
                             f"against lora_tpu's {S9_JAX_HARD} / "
                             f"{S9_JAX_SOFT} (bar {S9_JAX_SLACK})")
    return {f"{what}, fused='auto'": la, f"{what}, fused='off'": lo}


def s9b_wire(dev) -> tuple:
    """bench_e2e's wire as its main builds it: the SF10 group, then the
    SF8 group of --mixed-sf, from one generator seeded 0."""
    from lora_tpu_torch.tools import bench_e2e as e2e

    rng = np.random.default_rng(0)
    return tuple(e2e.make_group(sf, E2E_SLAB, E2E_PAYLOAD, rng, dev)
                 for sf in (10, 8))


def s9b_e2e(torch, dev, sync, wire) -> dict:
    """9b: tools.bench_e2e over E2E_CHANNELS channels in the default mode
    (planar int16), then 2 slabs in host-convert, interleaved and
    --mixed-sf, on the wire of s9b_wire (built before 9a); every frame
    found and decoded ok in every run; each run counted under the
    profiler, then run again outside it for its rates.
    -> {path: launches}."""
    from lora_tpu_torch.tools import bench_e2e as e2e

    g10, g8 = wire
    by_path = {}
    for mode, groups, channels in (
            ("planar", [g10], E2E_CHANNELS),
            ("host-convert", [g10], 2 * E2E_SLAB),
            ("interleaved", [g10], 2 * E2E_SLAB),
            ("planar", [g10, g8], 2 * E2E_SLAB)):
        what = (f"9b bench_e2e {mode}{' --mixed-sf' if len(groups) > 1 else ''}"
                f" {channels} channels")
        t = time.perf_counter()
        _, by_path[what] = count_launches(
            what, lambda: e2e.run(groups, mode, channels, dev), sync,
            (*S9_ABC, "decode"))
        rec, comp = e2e.run(groups, mode, channels, dev)
        if not rec.get("of") or not (rec["frames_found"]
                                     == rec["frames_decoded_ok"]
                                     == rec["of"] == channels):
            raise AssertionError(f"{what}: {rec}")
        print(f"{what}: {rec['of']} of {channels} frames found and decoded "
              f"ok, {rec['measured_Msamp_s']} Msamples/s end to end, "
              f"compute only {comp['compute_only_Msamp_s_per_slab']}, "
              f"host to device {comp['h2d_GBs_measured']} GB/s = "
              f"{comp['h2d_bound_Msamp_s_measured']} Msamples/s "
              f"({time.perf_counter() - t:.1f} s)", flush=True)
    return by_path


def s9c_soft_decode(torch, dev, sync) -> dict:
    """9c: tools.bench_soft and tools.bench_decode at B = S9_B, SF10, with
    their byte-exact gates.  -> {path: launches}."""
    from lora_tpu_torch.tools import bench_decode, bench_soft

    by_path = {}
    for name, mod in (("bench_soft", bench_soft),
                      ("bench_decode", bench_decode)):
        what = f"9c {name} B={S9_B}"
        t = time.perf_counter()
        _, by_path[what] = count_launches(
            what, lambda: mod.measure(S9_B, 10, dev, S9_REPS), sync,
            (*S9_TX, "decode"))
        print(f"{what}: {time.perf_counter() - t:.1f} s", flush=True)
    return by_path


def s9d_stream_examples(torch, dev, sync) -> dict:
    """9d: tools.bench_stream.bench_pump at its card defaults (every frame
    of every pass found and byte-exact), examples.wideband_rx (kernel D,
    then A, B, C; byte-exact) and examples.lora_simulation with piped lines
    (each message back byte-exact).  -> {path: launches}."""
    import contextlib
    import io

    from lora_tpu_torch.examples import lora_simulation, wideband_rx
    from lora_tpu_torch.runtime import decode_frames
    from lora_tpu_torch.tools import bench_stream

    by_path = {}
    t = time.perf_counter()
    what = "9d bench_stream.bench_pump"
    recs, by_path[what] = count_launches(
        what, lambda: bench_stream.bench_pump(device=dev), sync, S9_TX)
    first = sorted((f.channel, f.t_start) for f in recs[0]["frame_list"])
    decoded, by_path[f"{what} decode_frames"] = count_launches(
        f"{what} decode_frames", lambda: [
            decode_frames(r["frame_list"], r["cfg"], device=dev)
            for r in recs], sync, ("decode",), exactly=len(recs))
    for r, got in zip(recs, decoded):
        bad = [f.channel for f in got
               if f.payload != bytes(r["payload"][f.channel].tolist())]
        same = sorted((f.channel, f.t_start) for f in got) == first
        if r["frames"] != r["frames_in_reach"] or bad or not same:
            raise AssertionError(f"{what} {r['source']} {r['loop']}: "
                                 f"{r['frames']} frames of "
                                 f"{r['frames_in_reach']} in reach, "
                                 f"{len(bad)} not byte-exact, the first "
                                 f"pass's frames: {same}")
    print(f"{what}: every pass the same {recs[0]['frames_in_reach']} frames "
          f"byte-exact ({time.perf_counter() - t:.1f} s)", flush=True)

    t = time.perf_counter()
    what = "9d examples.wideband_rx"
    rc, by_path[what] = count_launches(
        what, lambda: wideband_rx.main(["--device", str(dev)]), sync,
        ("channelize", *S9_TX, "decode"))
    if rc != 0:
        raise AssertionError(f"{what}: exit {rc}")
    print(f"{what}: byte-exact ({time.perf_counter() - t:.1f} s)",
          flush=True)

    t = time.perf_counter()
    what = "9d examples.lora_simulation"
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc, by_path[what] = count_launches(
            what, lambda: lora_simulation.main(["--device", str(dev)],
                                               SIM_LINES), sync,
            (*S9_TX, "decode"))
    print(out.getvalue(), end="", flush=True)
    got = [ln.split("rx: ", 1)[1].split("   snr=")[0]
           for ln in out.getvalue().splitlines() if "  rx: " in ln]
    if rc != 0 or got != SIM_MESSAGES:
        raise AssertionError(f"{what}: exit {rc}, received {got}")
    print(f"{what}: {len(got)} messages back byte-exact "
          f"({time.perf_counter() - t:.1f} s)", flush=True)
    return by_path


def step9(torch, dev, sync) -> dict:
    """Step 9: the port's tools and examples on the card, each path's
    kernels counted from 0; 9b's wire is built first, outside every counted
    run (its frames launch kernel F).  -> {path: launches}."""
    t9 = time.perf_counter()
    wire = s9b_wire(dev)
    print(f"9b wire: built in {time.perf_counter() - t9:.1f} s", flush=True)
    by_path = {}
    for name, sub in (
            ("9a", s9a_sensitivity),
            ("9b", lambda *a: s9b_e2e(*a, wire)),
            ("9c", s9c_soft_decode), ("9d", s9d_stream_examples)):
        t = time.perf_counter()
        by_path.update(sub(torch, dev, sync))
        fresh(torch)
        print(f"step {name}: {time.perf_counter() - t:.1f} s", flush=True)
    print(f"step 9: {time.perf_counter() - t9:.1f} s", flush=True)
    return by_path


# ---------------------------------------------------------------------------
# step 10: the captured programs (utils/jit.py) against the eager route
# ---------------------------------------------------------------------------

def spread(times) -> str:
    t = sorted(times)
    return (f"median {t[len(t) // 2]:.3f}, min {t[0]:.3f}, max {t[-1]:.3f} "
            f"ms over {len(t)}")


def fields_bit_equal(torch, what, a, b) -> None:
    """Every field of two results (DemodResult, DecodeResult, tensors or
    tuples of them) bit-equal."""
    if isinstance(a, torch.Tensor):
        if not torch.equal(a, b):
            raise AssertionError(f"{what}: differs between the captured "
                                 "call and the eager one")
        return
    if isinstance(a, tuple):
        for i, (x, y) in enumerate(zip(a, b)):
            fields_bit_equal(torch, f"{what}[{i}]", x, y)
        return
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if (x is None) != (y is None):
            raise AssertionError(f"{what}: {f.name} present in one only")
        if x is not None and not torch.equal(x, y):
            raise AssertionError(f"{what}: {f.name} differs between the "
                                 "captured call and the eager one")


def step10(torch, dev, card, sync, profile=False) -> dict:
    """Step 10: each captured program against its disable_jit() call at
    full width: fields bit-equal, frames byte-exact, one capture a key, no
    host sync in a replay on resident input, times of both.
    -> {path: launches} of one counted replay a path."""
    from lora_tpu_torch import api
    from lora_tpu_torch.ops import channelizer as chz
    from lora_tpu_torch.utils import jit

    # the banks of steps 3, 4 and 5e, rebuilt from their seeds
    cfg, cfg3 = flagship_cfg(), config3_cfg()
    bank, payload = make_bank(api, cfg, B_FLAGSHIP, SIGMA, SEED, dev)
    halves = [make_bank(api, cfg, B_FLAGSHIP, SIGMA, SEED + 21 + i, dev)
              for i in range(2)]
    two = torch.cat([h[0] for h in halves], dim=1)
    pay2 = torch.stack([h[1] for h in halves], dim=1).reshape(
        2 * B_FLAGSHIP, -1)
    del halves
    wide, pay3 = make_wideband(api, chz, cfg3, C3_STREAMS, C3_K, C3_SIGMA,
                               SEED + 11, dev)
    want = [bytes(p) for p in payload.cpu().numpy().tolist()]
    B, K3 = B_FLAGSHIP, C3_K

    def frames(what, dec, sent):
        got = api.extract_payloads(dec)
        bad = sum(g != bytes(w) for g, w in zip(got, sent))
        if bad:
            raise AssertionError(f"{what}: {bad} of {len(sent)} frames not "
                                 "byte-exact")

    def hard(dem, n=B):
        return api.decode(dem.symbols.reshape(n, -1), cfg)

    def soft(route):
        d = api.demodulate(bank, cfg, spectra=True, fused=route)
        return d, api.decode_soft(d.fft_mag2, cfg)

    paths = {
        "demodulate": (
            lambda r: api.demodulate(bank, cfg, fused=r),
            lambda out: frames("demodulate", hard(out), want),
            bank.numel()),
        "channelized_demodulate (config 3)": (
            lambda r: api.channelized_demodulate(wide, K3, cfg3, fused=r),
            lambda out: frames(
                "config 3", api.decode(out[0].symbols[:, 0::2].reshape(
                    -1, cfg3.mtu), cfg3), pay3.reshape(-1, 16).cpu().numpy()),
            wide.numel()),
        "demodulate(spectra=True) + decode_soft": (
            soft, lambda out: frames("soft", out[1], want), bank.numel()),
        "demodulate(max_frames=2)": (
            lambda r: api.demodulate(two, cfg, max_frames=2, fused=r),
            lambda out: frames("max_frames=2", hard(out, 2 * B),
                               pay2.cpu().numpy()), two.numel()),
        "demodulate(debug=True)": (
            lambda r: api.demodulate(bank, cfg, debug=True, fused=r),
            lambda out: frames("debug", hard(out), want), bank.numel()),
    }
    expect = {"demodulate(debug=True)": ("detect", "track", "shift"),
              "channelized_demodulate (config 3)": ("channelize", "detect",
                                                    "track", "payload"),
              "demodulate(spectra=True) + decode_soft": ("detect", "track",
                                                         "payload", "decode")}
    by_path = {}
    pool_gb = None
    for what, (run, check, samples) in paths.items():
        for route in ("auto", "off"):
            jit.clear()
            sync()
            torch.cuda.empty_cache()
            r0 = torch.cuda.memory_reserved()
            with jit.disable_jit():
                eager = run(route)
            check(eager)
            first = run(route)  # the warm-up, returned, and the capture
            fields_bit_equal(torch, f"{what} {route} (first call)", first,
                             eager)
            del first
            if what == "demodulate" and route == "auto":
                sync()
                torch.cuda.empty_cache()
                pool_gb = (torch.cuda.memory_reserved() - r0) / 1e9
            n_cap = jit.captures()
            got = run(route)
            fields_bit_equal(torch, f"{what} {route}", got, eager)
            check(got)
            del got
            sync()
            torch.cuda.set_sync_debug_mode("error")
            try:
                run(route)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            sync()
            ms_e, ms_c = in_turns(unjitted(lambda: run(route)),
                                  lambda: run(route))
            name = f"10 captured {what} fused={route!r}"
            kernels = expect.get(what, ("detect", "track", "payload"))
            if route == "off":  # kernel G follows no route
                kernels = tuple(k for k in kernels if k == "decode")
            _, by_path[name] = count_launches(
                name, lambda: run(route), sync, kernels,
                exactly=1 if route == "auto" else None)
            if jit.captures() != n_cap:
                raise AssertionError(f"{what} {route}: "
                                     f"{jit.captures() - n_cap} captures "
                                     "over the timed calls")
            med = sorted(ms_c)[len(ms_c) // 2]
            rate = (f", captured {samples / (med * 1e-3) / 1e6:.1f} "
                    "Msamples/s" if samples else "")
            print(f"captured {what} fused={route!r}: every field bit-equal "
                  f"to disable_jit(), frames byte-exact, one capture, no "
                  f"host sync in a replay; eager {spread(ms_e)}; captured "
                  f"{spread(ms_c)}{rate} [{card}]", flush=True)
            if profile:
                with jit.disable_jit():
                    device_breakdown(f"eager {what} fused={route!r}",
                                     lambda: run(route),
                                     sorted(ms_e)[len(ms_e) // 2], sync,
                                     calls=1, top=0)
                device_breakdown(f"captured {what} fused={route!r}",
                                 lambda: run(route), med, sync, calls=1,
                                 top=0)
            del eager
    # a second two-frame bank, whose frames the search does not all find:
    # captured and eager alike, both routes alike; its frames are counted
    del two
    jit.clear()
    halves = [make_bank(api, cfg, B, SIGMA, SEED + 61 + i, dev)
              for i in range(2)]
    other = torch.cat([h[0] for h in halves], dim=1)
    opay = torch.stack([h[1] for h in halves], dim=1).reshape(2 * B, -1)
    del halves
    with jit.disable_jit():
        eager = api.demodulate(other, cfg, max_frames=2)
    for _ in range(2):
        fields_bit_equal(torch, "max_frames=2, second bank",
                         api.demodulate(other, cfg, max_frames=2), eager)
    routes_equal(torch, "max_frames=2, second bank", eager,
                 api.demodulate(other, cfg, max_frames=2, fused="off"))
    got = api.extract_payloads(hard(eager, 2 * B))
    n = sum(g == bytes(w) for g, w in zip(got, opay.cpu().numpy()))
    lost = [(i // 2, i % 2) for i in range(2 * B)
            if not bool(eager.found.reshape(-1)[i])]
    print(f"max_frames=2 on a second bank (seeds {SEED + 61}, {SEED + 62}): "
          f"captured equal to disable_jit(), the routes equal; {n} of "
          f"{2 * B} frames byte-exact, (channel, frame) not found: "
          f"{lost[:8]}", flush=True)
    del other, eager
    jit.clear()
    print(f"memory: the flagship demodulate(fused='auto') graph's pool "
          f"{pool_gb:.3f} GB reserved on the card (its outputs and the "
          f"eager result's included); "
          f"a program keeps {jit.MAXSIZE} graphs [{card}]", flush=True)
    return by_path


# ---------------------------------------------------------------------------
# step 11: the transmit half (encode, kernel F, the DC blocker) at full width
# ---------------------------------------------------------------------------

# kernel F against modulate_plain: bit-equal is the target (exact integer
# numerators, the same float32 sequence, the same full-precision cosf and
# sinf).  If the card's cosf/sinf and torch's cos/sin ever part, the largest
# difference is printed with the reason and held to 2 ulp at 1.0.
F_ATOL = 2.4e-7


def step11(torch, dev, card, sync):
    """Step 11: encode captured against eager, kernel F against
    modulate_plain, the F-built bank and the plain-built bank through the
    same channel to equal decisions and byte-exact frames, the DC blocker
    captured against eager across a seam; times and peak memory.
    -> (check, {path: launches}, (F ms, plain ms), bound)."""
    from lora_tpu_torch import api
    from lora_tpu_torch.models import modulator as tmod
    from lora_tpu_torch.ops import dcblock
    from lora_tpu_torch.utils import jit

    cfg = flagship_cfg()
    B, N = B_FLAGSHIP, cfg.N
    g = torch.Generator(device=dev).manual_seed(SEED)
    payload = torch.randint(0, 256, (B, 32), generator=g, device=dev,
                            dtype=torch.int64).to(torch.uint8)
    by_path = {}

    # ---- a. encode: the first call and a replay against the eager call ----
    jit.clear()
    with jit.disable_jit():
        eager = api.encode(payload, cfg)
    fields_bit_equal(torch, "encode (first call)", api.encode(payload, cfg),
                     eager)
    n_cap = jit.captures()
    sync()
    torch.cuda.set_sync_debug_mode("error")
    try:
        sym = api.encode(payload, cfg)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    fields_bit_equal(torch, "encode", sym, eager)
    S = sym.shape[1]

    # ---- b. the transmit path, counted; kernel F against its plain version
    what = "11 encode + modulate"
    iq, by_path[what] = count_launches(
        what, lambda: api.modulate(api.encode(payload, cfg), cfg), sync,
        ("modulate",), exactly=1)
    if jit.captures() != n_cap:
        raise AssertionError("11: encode captured again on a replay")
    plain = tmod.modulate_plain(sym, cfg)
    T = iq.shape[1]
    if iq.shape != (B, cfg.frame_samples(S)) or plain.shape != iq.shape:
        raise AssertionError(f"11: kernel F gave {tuple(iq.shape)}, plain "
                             f"{tuple(plain.shape)}")
    chk = Check("modulate")
    same = torch.equal(iq, plain)
    if not same:
        n = int((iq != plain).sum())
        print(f"kernel F differs from modulate_plain at {n} of {B * T} "
              f"samples, by at most {float((iq - plain).abs().max()):.3g}: "
              f"the numerators are exact integers and the float32 sequence "
              f"is the same, so the card's cosf/sinf and torch's cos/sin "
              f"part there; held to {F_ATOL}", flush=True)
    chk.close("real", iq.real, plain.real, tol=F_ATOL)
    chk.close("imag", iq.imag, plain.imag, tol=F_ATOL)
    print(f"kernel F: {'bit-equal to' if same else 'within ' + str(F_ATOL) + ' of'} "
          f"modulate_plain over {B} frames x {T} samples ({S} symbols)",
          flush=True)

    # ---- c. both banks through the same channel --------------------------
    Tb = api.required_samples(cfg)
    dems = []
    for name in ("kernel F", "plain"):
        g2 = torch.Generator(device=dev).manual_seed(SEED + 111)
        frames = iq if name == "kernel F" else plain
        bank = impair(frames, Tb, N, g2, 3 * N, 2, 0.4)
        bank = (bank + awgn(bank.shape, SIGMA, g2, dev)).contiguous()
        what = f"11 demodulate the {name}-built bank"
        dem, by_path[what] = count_launches(
            what, lambda: api.demodulate(bank, cfg), sync, S9_ABC)
        byte_exact(api, what, api.decode(dem.symbols, cfg), payload)
        dems.append(dem)
        del bank
    for f in ("found", "symbols", "count", "t_sync", "consumed",
              "freq_error"):
        if not torch.equal(getattr(dems[0], f), getattr(dems[1], f)):
            raise AssertionError(f"11: the F-built and plain-built banks "
                                 f"differ in {f}")
    print(f"11: the F-built and the plain-built bank, through the same "
          f"channel, give equal decisions; all {B} frames of each "
          f"byte-exact", flush=True)
    del dems, iq, plain
    sync()
    torch.cuda.empty_cache()

    # ---- d. the DC blocker: captured against eager across a seam, on blocks
    # the size of step 6c's dc_block replay chunks
    g3 = torch.Generator(device=dev).manual_seed(SEED + 112)
    x = (awgn((2 * REPLAY_CHUNK_K,), 1.0, g3, dev) + (3.0 - 1.5j)).contiguous()
    half = (x[:REPLAY_CHUNK_K], x[REPLAY_CHUNK_K:])
    with jit.disable_jit():
        y0, s0 = dcblock.dcblock(half[0])
        y1, s1 = dcblock.dcblock(half[1], state=s0)
    for i in range(3):
        a0, t0 = dcblock.dcblock(half[0])
        a1, t1 = dcblock.dcblock(half[1], state=t0)
        fields_bit_equal(torch, f"dcblock call {i}", (a0, t0, a1, t1),
                         (y0, s0, y1, s1))
    sync()
    torch.cuda.set_sync_debug_mode("error")
    try:
        dcblock.dcblock(half[1], state=s0)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    print(f"11: dcblock captured bit-equal to disable_jit() over two blocks "
          f"of {REPLAY_CHUNK_K} samples with the state across the seam; no host "
          "sync in a replay", flush=True)

    # ---- e. times and peak memory ------------------------------------------
    enc = lambda: api.encode(payload, cfg)
    enc_e, enc_c = in_turns(unjitted(enc), enc)
    mod_p, mod_f = in_turns(lambda: tmod.modulate_plain(sym, cfg),
                            lambda: api.modulate(sym, cfg))
    dc = lambda: dcblock.dcblock(half[1], state=s0)
    dc_e, dc_c = in_turns(unjitted(dc), dc)
    peak_f = peak_above(lambda: api.modulate(sym, cfg), sync)
    peak_p = peak_above(lambda: tmod.modulate_plain(sym, cfg), sync)
    out_gb = B * T * 8 / 1e9
    nbytes = B * T * 8 + B * S * 4 + (T - (S + cfg.padding) * cfg.NN) * 8
    # the float32 products of each data sample's sequence (num / D, * 2 pi,
    # the two * ampl); cosf and sinf's own polynomials are not counted
    bnd = bound(nbytes, 4.0 * B * S * cfg.NN)
    med = lambda t: sorted(t)[len(t) // 2]
    print(f"11 times at B = {B}, T = {T}: encode eager {spread(enc_e)}, "
          f"captured {spread(enc_c)}; modulate plain {spread(mod_p)}, "
          f"kernel F {spread(mod_f)} (bound {bnd['bound_ms']:.3f} ms by "
          f"{bnd['bound_by']}, {med(mod_f) / bnd['bound_ms']:.2f}x it); "
          f"dcblock on {REPLAY_CHUNK_K} samples eager {spread(dc_e)}, captured "
          f"{spread(dc_c)} [{card}]", flush=True)
    print(f"11 memory: modulate allocates at its peak {peak_f:.3f} GB on "
          f"kernel F and {peak_p:.3f} GB on the plain route, for an output "
          f"of {out_gb:.3f} GB [{card}]", flush=True)
    jit.clear()
    return chk, by_path, (med(mod_f), med(mod_p)), bnd


# ---------------------------------------------------------------------------
# step 12: kernel G (decode) at both cells' shapes
# ---------------------------------------------------------------------------

def step12(torch, dev, card, sync):
    """Step 12: kernel G against decode_plain at the SF10 bank's shape and
    at the wideband cell's: every field bit-equal, one launch a call, the
    encoded half decoded OK; times of kernel G, of decode_plain captured
    and of decode_plain eager, and kernel G's bound by bytes.
    -> (Check, {path: launches}, {shape: times}, {shape: bound})."""
    from lora_tpu_torch import LoRaConfig, api
    from lora_tpu_torch.models import decoder as tdec
    from lora_tpu_torch.utils import jit, trace

    @jit.program(static=("cfg", "num_symbols"))
    def plain_graph(sym, cfg, num_symbols, device):
        """the route decode took before kernel G: decode_plain, one graph"""
        return tdec.decode_plain(sym.to(device), cfg, num_symbols)

    shapes = {
        "sf10-bank": (flagship_cfg(), (B_FLAGSHIP,), 4),
        "wideband": (LoRaConfig(sf=7, cr="4/5", preamble_symbols=16,
                                sync=0x2B), (256, 64), 2),
    }
    chk = Check("decode")
    by_path, times, bounds = {}, {}, {}
    for name, (cfg, lead, tail) in shapes.items():
        cfg = cfg.replace(crc_check=True)
        B = int(np.prod(lead))
        g = torch.Generator(device=dev).manual_seed(SEED + 120)
        pay = torch.randint(0, 256, (B, 32), generator=g, device=dev,
                            dtype=torch.int64).to(torch.uint8)
        sym = api.encode(pay, cfg)
        sym = torch.cat([sym, torch.randint(0, cfg.N, (B, tail), generator=g,
                                            device=dev, dtype=torch.int32)],
                        dim=1)
        sym[B // 2 :] = torch.randint(0, cfg.N, sym[B // 2 :].shape,
                                      generator=g, device=dev,
                                      dtype=torch.int32)
        x = sym.to(torch.int16).reshape(*lead, -1).contiguous()
        S = x.shape[-1]
        what = f"12 decode ({name}, {tuple(x.shape)})"
        got, by_path[what] = count_launches(
            what, lambda: api.decode(x, cfg), sync, ("decode",), exactly=1)
        want = tdec.decode_plain(x, cfg, S)
        for f in dataclasses.fields(want):  # bit-equal: held to 0
            chk.close(f"{what} {f.name}", getattr(got, f.name),
                      getattr(want, f.name), tol=0)
        ok = got.status.reshape(-1)[: B // 2]
        if not bool((ok == 0).all()):
            raise AssertionError(f"{what}: {int((ok != 0).sum())} encoded "
                                 "frames not decoded OK")
        fields_bit_equal(torch, f"{what} captured plain",
                         plain_graph(x, cfg, S, dev), want)
        kern = lambda: api.decode(x, cfg)
        graph = lambda: plain_graph(x, cfg, S, dev)
        ms_p, ms_g = in_turns(graph, kern)
        ms_e = run_times(lambda: tdec.decode_plain(x, cfg, S))
        # the kernel's own device time: a call's CUDA events also hold the
        # wrapper's host time, during which the card waits
        sync()
        with trace.session() as prof:
            for _ in range(2 * RUNS):
                kern()
            sync()
        ev = [e for e in prof.key_averages() if "decode_kernel" in e.key]
        dev_ms = sum(e.self_device_time_total for e in ev) / 1e3 / (2 * RUNS)
        if sum(e.count for e in ev) != 2 * RUNS:
            raise AssertionError(f"{what}: the trace holds "
                                 f"{sum(e.count for e in ev)} launches of "
                                 f"kernel G, not {2 * RUNS}")
        M = got.data.shape[-1]
        bnd = bound(B * S * 2 + B * M + B * (7 * 4 + 1), 0.0)
        med = lambda t: sorted(t)[len(t) // 2]
        print(f"12 decode at {name} {tuple(x.shape)} int16: kernel G "
              f"{dev_ms * 1e3:.2f} us on the card (bound "
              f"{bnd['bound_ms'] * 1e3:.3f} us by {bnd['bound_by']}, "
              f"{dev_ms / bnd['bound_ms']:.0f}x it), a call (CUDA events, "
              f"the wrapper's host time within) {spread(ms_g)}; "
              f"decode_plain captured {spread(ms_p)}, eager {spread(ms_e)}; "
              f"every field bit-equal, {B // 2} encoded frames OK "
              f"[{card}]", flush=True)
        times[name] = {"ms": dev_ms, "call_ms": med(ms_g),
                       "plain_ms": med(ms_e), "captured_plain_ms": med(ms_p)}
        bounds[name] = bnd
        del x, sym, got, want
    jit.clear()
    return chk, by_path, times, bounds


# ---------------------------------------------------------------------------
# step 13: kernel R (the fractional resampler) at the US902-928 cell's shape
# ---------------------------------------------------------------------------

# 8,192 channels of 65,536 samples at the 200-kHz slot rate -> 40,960 at
# the 125-kHz LoRa rate (phybench's us915-wideband-128)
R_ROWS = 8192
R_T = 65536
R_M = 40960
R_RATIO = 1.6


def step13(torch, dev, card, sync):
    """Step 13: kernel R against the plain route at the US902-928 cell's
    shape: its register-blocked route (the plan's period of 5 outputs over
    8 inputs) bit-equal, one launch a call, named as the blocked route in
    the profiler's record; its device time by the profiler beside its bound,
    a call and the plain route by CUDA events; the general route on the
    same plan and on a plan without a short period (4.096, a period of 125
    outputs) on the same rows, timed by the profiler in turns with it, the
    latter bit-equal too.  -> (Check, {path: launches}, (kernel ms, plain
    ms), bound)."""
    from lora_tpu_torch.ops import cuda_resample
    from lora_tpu_torch.ops import resample as rs
    from lora_tpu_torch.utils import trace

    g = torch.Generator(device=dev).manual_seed(SEED + 130)
    x = torch.randn((R_ROWS, R_T), dtype=torch.complex64, device=dev,
                    generator=g)
    plan = rs.plan_on(0, R_M, R_RATIO, 0, dev)
    runs = plan.runs
    if runs is None:
        raise AssertionError("13: the cell's plan takes kernel R's general "
                             "route")
    taps = rs._taps_eff(R_RATIO)
    what = f"13 resample ({R_ROWS} x {R_T} -> {R_M}, {taps} taps)"
    kern = lambda: rs.weigh(x, plan, R_RATIO)
    general = lambda: rs.weigh(x, plan._replace(runs=None), R_RATIO)
    plain = lambda: rs.weigh(x, plan, R_RATIO, plain=True)
    chk = Check("resample")
    by_path = {}
    got, by_path[what] = count_launches(what, kern, sync, ("resample",),
                                        exactly=1)
    blocked = by_path[what]["blocked"]
    if blocked != 1:
        raise AssertionError(f"{what}: the call took kernel R's general "
                             "route")
    chk.close(what, torch.view_as_real(got), torch.view_as_real(plain()),
              tol=0)
    del got
    ms_k, ms_p = interleaved(kern, plain, sync)
    # a plan without a short period on the same rows: the general route
    r2 = 4.096
    m2 = int((R_T - rs._taps_eff(r2)) / r2)
    plan2 = rs.plan_on(0, m2, r2, 0, dev)
    if plan2.runs is not None:
        raise AssertionError("13: 4.096's plan takes the blocked route")
    general2 = lambda: rs.weigh(x, plan2, r2)
    chk.close(f"13 resample at {r2} ({R_ROWS} x {R_T} -> {m2})",
              torch.view_as_real(general2()),
              torch.view_as_real(rs.weigh(x, plan2, r2, plain=True)), tol=0)
    sync()
    dev_ms = {}
    for name, fn in (("blocked", kern), ("general", general),
                     ("general 4.096", general2), ("general 4.096", general2),
                     ("general", general), ("blocked", kern)):
        with trace.session() as prof:
            for _ in range(RUNS):
                fn()
            sync()
        n = trace.launches(prof)
        want = RUNS if name == "blocked" else 0
        if n["resample"] != RUNS or n["blocked"] != want:
            raise AssertionError(f"{what}: the trace holds {n['resample']} "
                                 f"launches of kernel R, {n['blocked']} "
                                 f"blocked, not {RUNS} and {want} ({name})")
        blocked += n["blocked"]
        ev = [e for e in prof.key_averages() if "resample_kernel" in e.key]
        ms = sum(e.self_device_time_total for e in ev) / 1e3 / RUNS
        dev_ms[name] = min(dev_ms.get(name, ms), ms)
    bnd = bound(R_ROWS * (R_T + R_M) * 8, 4 * taps * R_ROWS * R_M)
    bnd2 = bound(R_ROWS * (R_T + m2) * 8, 4 * rs._taps_eff(r2) * R_ROWS * m2)
    share = lambda ms, b: f"{100 * b['bound_ms'] / ms:.1f}%"
    print(f"{what}: kernel R, register-blocked route (period {runs.period} "
          f"outputs over {runs.advance} inputs, runs of "
          f"{cuda_resample.RUN} periods, align {runs.align}; "
          f"{blocked} register-blocked launches in the profiler's "
          f"records: the counted call and two sessions) "
          f"{dev_ms['blocked']:.3f} ms on the card "
          f"({share(dev_ms['blocked'], bnd)} of its bound "
          f"{bnd['bound_ms']:.3f} ms by {bnd['bound_by']}); the general "
          f"route on the same plan {dev_ms['general']:.3f} ms "
          f"({share(dev_ms['general'], bnd)}); a call (CUDA events) "
          f"{ms_k:.3f} ms, the plain route {ms_p:.3f} ms; bit-equal "
          f"[{card}]", flush=True)
    print(f"13 resample at {r2} ({R_ROWS} x {R_T} -> {m2}, "
          f"{rs._taps_eff(r2)} taps, no short period): kernel R's general "
          f"route {dev_ms['general 4.096']:.3f} ms on the card "
          f"({share(dev_ms['general 4.096'], bnd2)} of its bound "
          f"{bnd2['bound_ms']:.3f} ms by {bnd2['bound_by']}); bit-equal "
          f"[{card}]", flush=True)
    del x
    return chk, by_path, (dev_ms["blocked"], ms_p), bnd


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port's kernels "
                         "run only on the card")
    repo = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, repo)
    from lora_tpu_torch.benchmarks import card_line
    from lora_tpu_torch.ops import _cuda

    card = card_line()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    sync = torch.cuda.synchronize
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    # ---- 2. build ----------------------------------------------------------
    t = time.perf_counter()
    _cuda.library()
    print(f"build: {time.perf_counter() - t:.1f} s "
          f"({_cuda.library_path().name})", flush=True)

    profile = "--profile" in sys.argv[1:]
    checks, launches, ms, bounds = flagship(torch, dev, card, sync, profile)
    fresh(torch)
    (checks["channelize"], c3_launches, ms["channelize"],
     bounds["channelize"]) = config3(torch, dev, card, sync, checks, profile)
    fresh(torch)
    (checks["shift"], by_path, ms["shift"], lib_shift,
     bounds["shift"]) = receive_options(torch, dev, card, sync, checks,
                                        profile)
    fresh(torch)
    by_path6 = step6(torch, dev, card, sync, checks, profile)
    fresh(torch)
    by_path7 = step7(torch, card)
    chk16, ms16, bound16, by_path8 = step8(torch, dev, card, sync, profile)
    fresh(torch)
    by_path9 = step9(torch, dev, sync)
    fresh(torch)
    t10 = time.perf_counter()
    by_path10 = step10(torch, dev, card, sync, profile)
    print(f"step 10: {time.perf_counter() - t10:.1f} s", flush=True)
    fresh(torch)
    t11 = time.perf_counter()
    (checks["modulate"], by_path11, ms["modulate"],
     bounds["modulate"]) = step11(torch, dev, card, sync)
    print(f"step 11: {time.perf_counter() - t11:.1f} s", flush=True)
    fresh(torch)
    t12 = time.perf_counter()
    checks["decode"], by_path12, ms12, bounds12 = step12(torch, dev, card,
                                                         sync)
    print(f"step 12: {time.perf_counter() - t12:.1f} s", flush=True)
    fresh(torch)
    t13 = time.perf_counter()
    (checks["resample"], by_path13, ms["resample"],
     bounds["resample"]) = step13(torch, dev, card, sync)
    print(f"step 13: {time.perf_counter() - t13:.1f} s", flush=True)
    # every driven path's run, each counted from 0
    by_path = {"demodulate(fused='auto') + decode": launches,
               "channelized_demodulate(fused='auto')": c3_launches, **by_path,
               **by_path6, **by_path7, **by_path8, **by_path9, **by_path10,
               **by_path11, **by_path12, **by_path13}

    sources = {
        "detect": ("lora_tpu_torch/csrc/detect.cu",
                   "lora_tpu/ops/pallas_detect.py:387"),
        "track": ("lora_tpu_torch/csrc/track.cu",
                  "lora_tpu/ops/pallas_demod.py:1059, "
                  "lora_tpu/ops/pallas_demod.py:1169"),
        "payload": ("lora_tpu_torch/csrc/payload.cu",
                    "lora_tpu/ops/pallas_demod.py:465, "
                    "lora_tpu/ops/pallas_demod.py:792, "
                    "lora_tpu/ops/pallas_demod.py:627"),
        "channelize": ("lora_tpu_torch/csrc/channelize.cu",
                       "lora_tpu/ops/pallas_channelize.py:376, "
                       "lora_tpu/ops/pallas_channelize.py:187"),
        "shift": ("lora_tpu_torch/csrc/shift.cu", "lora_tpu/ops/shift.py:68"),
        "modulate": ("lora_tpu_torch/csrc/modulate.cu",
                     "XLA fusion of lora_tpu/models/modulator.py:72 "
                     "(no pallas_call)"),
        "resample": ("lora_tpu_torch/csrc/resample.cu",
                     "XLA fusion of lora_tpu/ops/resample.py:80 `_apply` "
                     "(no pallas_call)"),
    }
    # the one PyTorch call that computes a kernel's function, where there is
    # one: torch.take_along_dim for the shift; the others fuse a dechirp, a
    # transform and reductions, a polyphase FIR and an IDFT, or a chirp
    # synthesis with a prefix sum
    library = {"shift": lib_shift}
    kernels = [
        {
            "name": name,
            "route": "cuda",
            "source": sources[name][0],
            "replaces": sources[name][1],
            "launches": sum(n[name] for n in by_path.values()),
            "launches_by_path": {p: n[name] for p, n in by_path.items()},
            "max_abs_err": checks[name].max_abs_err,
            "ms": ms[name][0],
            "plain_ms": ms[name][1],
            **bounds[name],
            "library_ms": library.get(name),
        }
        for name in ("detect", "track", "payload", "channelize", "shift",
                     "modulate", "resample")
    ]
    # kernel D's bf16 route (step 8b, route 3): its time against its plain
    # version and the float32 route's, its error, its bound and the matmul
    # yardstick of its IDFT
    row_d = next(k for k in kernels if k["name"] == "channelize")
    row_d["bf16"] = {"max_abs_err": chk16.max_abs_err, **ms16, **bound16}
    # kernel G: its launches over every path, its difference from
    # decode_plain (step 12, held to 0), its times at both cells' shapes
    kernels.append({
        "name": "decode", "route": "cuda",
        "source": "lora_tpu_torch/csrc/decode.cu",
        "replaces": "XLA fusion of lora_tpu/models/decoder.py:104 "
                    "(no pallas_call)",
        "launches": sum(n["decode"] for n in by_path.values()),
        "launches_by_path": {p: n["decode"] for p, n in by_path.items()},
        "max_abs_err": checks["decode"].max_abs_err,
        **ms12["sf10-bank"], **bounds12["sf10-bank"], "library_ms": None,
        "wideband": {**ms12["wideband"], **bounds12["wideband"]},
    })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
