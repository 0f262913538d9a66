#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (``mptpu_torch``) on one CUDA card and
check it: the greedy matching-pursuit encoder at the bench configuration,
multiband dictionary learning at its full width, the rest of the sparse
layer (OMP refit, feature-map loss, top-k, quantize, sharded MP), the
audio-splatting overfit at its full width, the SIAM codec's serving
path at its full width, the playable state-space model's overfit at its
full width, SIAM training (both trainers) at its full width, and the
models on those layers: the whole-song splat trainer, the playable
instrument, event search and the learned-atom MP; then the long-tail
overfit models (room simulation, textural, functional song, audio
operator) and the remaining layers; then the perceptual stack, the
remaining losses and the resonance chain with their three entry points
(resonance overfit, phase invariance, texture synthesis); then the rest of
the generator zoo, the energy-instrument overfit and the GAN and
experiment-runner trainers.

    python3 chip_smoke.py

Phases, each printing lines (any failure exits non-zero):

1. the card's name and power limit (``nvidia-smi``), then the build of
   the CUDA kernels from ``mptpu_torch/csrc`` and its time;
2. each of the six kernels against its plain PyTorch version, on the
   card, at the bench shapes (32 items, 512 atoms x 512 taps, 16,384
   samples, block 128) on a planted signal with decisive maxima; the
   cluster step kernel also against the one-block step kernel bit for bit
   (1, 3 and 32 items, clusters of 1, 2, 4, 8 and 16, with and without the
   tail gate, at 2,048-tap atoms, at the block of 512 at which
   ``dictionary_learning_step`` encodes, and at the largest and smallest
   multiband band), both step kernels' chains of ``n_steps`` launches against the same
   steps launched one by one, bit for bit, the whole-encode kernel at every
   cluster size the card admits against the one-block step kernel looped,
   bit for bit, the lane-table encode at every cluster size, with and
   without the tail gate, against the whole-encode kernel at the same size
   bit for bit (and its lane table against the final map), the launch probe
   (plain launches, launches chained under programmatic stream
   serialization, one in-kernel loop) against its plain version;
3. the paths, each with the launch counts set to 0 just before and read
   just after (phase 4 alike): the bench configuration through
   ``sparse_code_fast`` (``bench.py``'s inputs and settings; whole-encode
   kernel, timed), then
   the same through the lane-table encode (timed), and the two kernels
   timed in turns on copies of the same fresh state; four
   more paths of ``sparse_code_fast`` (cluster step kernel, one-block step
   kernel, lane-table encode, unfused with the boundary kernel), whose
   events on the planted signal must equal the naive ``sparse_code``'s;
   multiband dictionary learning (``scripts/multiband_bench.py``'s model
   and signal: 7 bands x 512 atoms x 128 taps x 2^15 samples x 64 steps,
   batch 4) through ``MultibandDictionaryLearning.recon / encode / learn /
   decode_global``, timed, recon SNR rising after learning; the launch
   probe, each kind timed by the host clock and by CUDA events behind a
   device spin long enough that all its launches are queued first;
4. the sparse layer at the bench width on the planted signal, one line a
   part, CUDA events beside the host clock: ``omp_refit`` after the bench
   encode (one whole-encode kernel launch; events kept, waveform error not
   above the greedy one's, values beside a float64 numpy solve);
   ``sparse_feature_map`` (its non-zeros the naive coder's events) and
   ``sparse_coding_loss`` forward and backward, the backward's peak memory
   under 16 GiB, and at a small shape the card's loss and gradient against
   the CPU's; ``SparseCodingLoss`` with two learning calls of 100 cluster
   step kernel launches each and a third with none; the STE, top-k and
   quantize functions on the card against the CPU, forward and gradient;
   ``sharded_sparse_code`` on a process group of one NCCL rank, its events
   the naive coder's; after the counted run, the learning path's encode
   (one chain of 100 cluster step kernel launches at block 512) against the
   naive coder;
6. (after phase 4, before phase 5's times) the splat overfit at
   ``scripts/splat.py``'s configuration (2^16 samples, 22,050 Hz, 64
   events, context 16, Adam lr 1e-3) on a seeded signal of three decaying
   sines plus noise: one forward and backward on the card against the CPU
   from one ``state_dict`` and one noise draw (events, loss, the gradients
   by group; the times' gradients, float32 noise on either side, in
   float64), ``overfit_splat`` for 5 warm-up and 200 timed steps (steps/s,
   the loss must fall, no step skipped by the NaN guard), one step split
   by CUDA events into forward, loss, backward and optimizer and traced
   (kernel launches a step, device busy and idle share, peak memory under
   16 GiB), 20 steps of the iterative loss (finite), and no launch of the
   six kernels;
7. (after phase 6, before phase 5's times) the SIAM codec (BASELINE #4)
   at sw6's shapes (2^17 samples, 32 events, hidden 128, context 32, STFT
   2048/256, ``scripts/codec_rate.py``'s flags) from parameters seeded
   with 0 and one noise draw from a CUDA generator seeded with 0, on the
   first window of ``codec_rate.py``'s segment (seed 3, fade-tailed): the
   encode (frames identical, vectors rtol 1e-4, channels within 1e-4 of
   their largest), the f16 wire decode and the alignment refinement within
   256 samples (both devices decode the card's wire bits; shifts
   identical; raw, wire and refined SNR within 0.01 dB), on the card
   against the CPU; the handoff walk over the 262,144-sample segment
   (within 1e-4); host ms of encode, decode, refinement and walk; one
   encode traced (launches, busy and idle share) and its peak memory; the
   encode and the bare inverse FFT against float64 with and without the
   end coefficients made real; no launch of the six kernels;
8. (after phase 7, before phase 5's times) the playable state-space model
   (BASELINE #5, ``scripts/ssm_article.py``'s configuration: 2^18 samples,
   window 128, control plane 64, state 128, the top 512 sites; Adam at lr
   1e-3, where the script's 1e-2 makes the loss rise first) on its target from ``get_one_audio_segment(2**18, seed=0)``, read
   from the demo corpus that ``ensure_demo_dataset`` writes under a
   temporary ``MPTPU_CACHE``: one forward and backward on the card against
   the CPU from one ``state_dict`` (audio and boundary differences within
   1e-5 of their largest, loss rtol 1e-4; the gradients by group in float64
   within 1e-8 of their largest, in float32 printed beside each device's
   distance from float64), the card's float32 audio against float64 on the
   card, cuDNN's RNN with TF32 allowed and not against float64;
   ``train_model_for_segment`` for 5 warm-up and 100 timed steps (steps/s,
   the loss must fall), one step traced (launches, busy and idle share)
   and its peak memory, ``random`` and ``rolled_control_plane`` finite and
   max-normed, the weights JSON round trip; ``CompressionModel`` at its
   full width (2^17 samples, window 1024, control 32, state 64, complex;
   ``param_count`` 621,866), forward and the gradient of sum(|audio|), and
   ``SSM`` and ``StateSpaceModelEventGenerator`` forward at BASELINE #5's
   widths, each on the card against the CPU; no launch of the six kernels;
9. (after phase 8, before phase 5's times) SIAM training (BASELINE #4)
   under sw6's flags (``models.siam_overfit.SW6``) at full width from
   parameters seeded with 0 and a fixed noise drawn from a CUDA generator
   seeded with 0: ``overfit_siam`` for 30 steps with evals at 10 and 20
   and a walk eval at 20 (ms a step, the loss falling, every step finite,
   one step traced: launches, busy and idle share; peak memory); one
   forward and backward on the card against the CPU from one
   ``state_dict`` with TF32 allowed for the process, so that the step's
   own ``no_tf32`` is what holds (frames and refinement shifts identical,
   loss rtol 1e-4, channels within 1e-4 of their largest, the gradients by
   group within 1e-8 of their largest in float64 and within 1e-4 in
   float32, where a backward in TF32 reads 3.7e-4 and more);
   one step with a NaN waveform weight (parameters, Adam's state and the
   EMA bit-identical, no device-to-host copy in its trace);
   ``train_and_monitor`` at batch 2 on the demo corpus under a temporary
   ``MPTPU_CACHE`` for 5 steps through ``make_data_parallel_step`` on a
   one-rank NCCL group, and one reservoir preview; no launch of the six
   kernels;
10. (after phase 9, before phase 5's times) the models on ported layers
   (ROADMAP A10), their demo corpus under a temporary ``MPTPU_CACHE``:
   the whole-song splat trainer at ``scripts/songsplat.py``'s reference
   configuration (2^19-sample song, 2^15-sample segments, 190 events,
   capacity 32): one forward and backward on the card against the CPU at a
   window with more events in range than the capacity (the range query's
   indices identical; loss; gradients by group in float64 and float32),
   ``train_songsplat`` for 5 + 100 steps (steps/s, every step finite, the
   loss over the render's segments falling), one step traced, the
   whole-song render with and without the gain refit; the instrument at
   sw6's shapes (a phrase of random notes, a bank harvested from the first
   window of codec_rate.py's segment and a phrase of it; card against CPU);
   ``index_corpus`` at ``scripts/build_index.py``'s defaults (the cluster
   step kernel's launches, by band, must be above 0; a query finds itself;
   card against CPU on 4 chunks); the learned-atom MP at 128 x 1,024 atoms
   over 2^15 samples, 25 iterations (card against CPU: events identical,
   channels, gradients in float64; 20 Adam steps at lr 1e-2, one traced);
   no launch of the other five kernels, nor of the cluster step kernel
   outside ``index_corpus``;
11. (after phase 10, before phase 5's times) the long-tail models (ROADMAP
   A11) at their scripts' defaults, each held to ``mptpu``'s loss
   trajectory from the port's seed-0 parameters and the same draws
   (``LONGTAIL_REFERENCE``, from tests/reference/*_trajectory.py): the room
   simulation (block 64, 512 frames, 5 x 17 x 9 voxels; card against CPU)
   and its 5 x 5 overfit at lr 1e-2; ``train_textural``, ``train_funcsong``
   and ``train_audiooperator`` (random batches and ``--overfit``; its
   trajectories at 2^13 samples in runs of their own), each after one step
   on the card against the CPU from the same parameters and batch (loss;
   gradients in float64), each with ms a step, a traced step (launches,
   busy and idle share) and peak memory; the A4 layers, the five custom
   gradients, the phase codec and the multiresolution shells at small
   sizes, card against CPU in float64; no launch of the six kernels;
12. (after phase 11, before phase 5's times) A5 and A6 at their scripts'
   defaults, each held to ``mptpu``'s loss trajectory from the port's
   seed-0 parameters or start and the same draws (``PERCEPTUAL_REFERENCE``,
   from tests/reference/*_trajectory.py): ``overfit_resonance`` at 2^15
   samples (34,090,383 parameters) on ``mptpu``'s impulse noise
   (tests/reference/resonance_noise.npy), after one step on the card
   against the CPU on ``get_one_audio_segment(2**15, seed=9)`` (loss; float64
   loss and gradients); ``run_phaseinvariance`` at 2^17 samples, each of
   its three transforms; ``synthesize_texture`` at 2^17 samples with the
   texture features (one step card against CPU) and with the scattering
   features (at 2^17 its first loss against the CPU's forward, one float32
   step's gradient card against CPU and a fall; held to ``mptpu`` at
   ``--tiny``); each with ms a step, a traced step
   (launches, busy and idle share) and peak memory; the A5 modules that no
   script reaches, card against CPU in float64; no launch of the six
   kernels;
13. (after phase 12, before phase 5's times) the rest of the ``gen/`` zoo,
   the energy-instrument overfit and the two trainers (ROADMAP A9a) at the
   widths of ``ZOO`` (each with its source): ``overfit_energy`` at
   scripts/energy_overfit.py's defaults (2^15 samples, block 512, 128
   channels, 3 layers) for 100 steps held to ``mptpu``'s trajectory
   (``ENERGY_REFERENCE``, from tests/reference/energy_trajectory.py), after
   one step on the card against the CPU on ``get_one_audio_segment(2**15,
   seed=5)`` (loss; float64 loss and gradients); each generator of the zoo
   (the spring mesh, the two waveguides, the transfer-function segment
   generator, the recurrent synth, the audio model, the instrument stack,
   the five lookups, the three event variants, the conv-impulse generator,
   the REDS model in both branches) on the card against the CPU, a float32
   forward and a float64 forward and gradient, with ms and launches of one
   forward; ``make_gan_steps`` (one step of each player, float64, card
   against CPU) and ``BaseExperimentRunner`` with checkpoints and
   ``resume``; no launch of the six kernels;
5. each kernel's time beside its plain version's, its bound and, for the
   boundary kernel, one ``torch.matmul`` computing the same product; the two
   step kernels per step from a chain of launches, with and without
   programmatic stream serialization; a chain of one encode's steps at each
   multiband band beside the whole-encode kernel doing the same steps in one
   launch; the two whole-encode kernels and the cluster step kernel by
   cluster size, with the clusters the card holds at once beside each;
14. a ``kernels`` JSON line, then the result line
    ``{"ok": true, "device": {...}}``.

It needs CUDA and the ``mptpu_torch`` package beside it, and exits with
code 2 without either.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# bench.py:133-139,182-188
BENCH = dict(batch=32, n_atoms=512, atom_size=512, n_samples=16384, n_steps=100, block=128, depth=3)

# scripts/multiband_bench.py:30-33
MULTIBAND = dict(n_samples=2**15, steps=64, n_atoms=512, atom_size=128, batch=4, learn_iters=2,
                 sizes=(512, 1024, 2048, 4096, 8192, 16384, 32768))
# atoms of more taps than a block of the step kernels holds in registers
LONG_ATOMS = dict(batch=2, n_atoms=16, atom_size=2048, n_samples=16384, n_steps=4, block=128,
                  clip_taps=1600)
PROBE_STEPS = 3200   # scripts/grid_overhead_probe.py:53
# the sparse layer's loss at a small shape, on the card against the CPU
SMALL_LOSS = dict(batch=2, n_atoms=16, atom_size=128, n_samples=1024, n_steps=8)
# scripts/splat.py:34-40,67 (BASELINE #3), driven for a few hundred steps
SPLAT = dict(n_samples=2**16, samplerate=22050, n_events=64, context_dim=16, lr=1e-3, warmup=5,
             steps=200, iterative_steps=20)
# phase 6, the card against the CPU: events (atol, of their largest), loss
# (relative), gradients (rtol and atol of each array's largest; the times'
# in float64, in float32 they are rounding noise on either side)
SPLAT_TOL = dict(events=1e-4, loss=1e-4, gradients=1e-3, times64=1e-6)
# sw6's shapes (BASELINE #4, trained_weights/siam_overfit_full_sw6): the first window of
# scripts/codec_rate.py's segment (262,144 samples, 24 events, seed 3), max_shift 256
SIAM = dict(n_samples=2**17, n_events=32, hidden=128, context_dim=32, window=2048, step=256,
            walk_samples=262144, audio_events=24, max_shift=256, reps=3)
# phase 7, the card against the CPU: channels, the wire decode, the refined decode
# and the walk within this share of their largest magnitude
SIAM_TOL = 1e-4
# scripts/ssm_article.py:63-99 (BASELINE #5: 2^18 samples, window 128, control plane 64,
# state 128, the top 512 sites; 188,416 parameters), driven for 5 + 100 steps at lr 1e-3:
# at the script's 1e-2 the loss rises 350- to 990-fold within 33 to 149 steps on each file
# of the demo corpus, and at 1e-3 it falls on each (tools/ssm_lr.py; ROADMAP.md, queue C); the
# codec-sized CompressionModel (mptpu/gen/ssm_complex.py:102-124: 2^17 samples, window
# 1024, control 32, state 64; param_count 621,866); SSM and the SSM event generator at
# the overfit's widths over its 2,048 frames, 4 events
SSM = dict(n_samples=2**18, window=128, control=64, state=128, sites=512, params=188_416,
           lr=1e-3, warmup=5, steps=100,
           compression=dict(n_samples=2**17, window=1024, control=32, state=64, params=621_866),
           generator=dict(frames=2048, events=4, hyper=16, latent=8))
# the same at a small size, for a rehearsal on the CPU
SSM_SMALL = dict(n_samples=2**12, window=32, control=8, state=16, sites=32, params=2_560,
                 lr=1e-2, warmup=1, steps=3,
                 compression=dict(n_samples=2**12, window=64, control=8, state=16, params=4_882),
                 generator=dict(frames=32, events=2, hyper=8, latent=4))
# the SSM overfit's parameters by group: the control plane, the input projection, the
# RNN, the output projection
SSM_GROUPS = {"control": ["control"], "proj": ["ssm.proj"],
              "rnn": ["ssm.rnn.weight_ih_l0", "ssm.rnn.weight_hh_l0"], "out_proj": ["ssm.out_proj"]}
# phase 8, the card against the CPU: audio and boundary differences (of their largest),
# loss (relative), gradients (of each group's largest; in float64 on both sides, and
# CompressionModel's, whose loss has no such noise, in float32)
SSM_TOL = dict(audio=1e-5, loss=1e-4, gradients=1e-4, gradients64=1e-8)
# scripts/siam_overfit.py under sw6's flags (its metrics.json config) at full width, driven for
# 30 steps with an eval every 10 and one walk eval; one step on the card against the CPU
# (cpu_events of the 32 events); train_siam.py's train_and_monitor at batch 2 for 5 steps
SIAM_TRAIN = dict(tiny=False, steps=30, eval_every=10, walk_eval_every=20, cpu_events=32,
                  batch=2, dp_steps=5)
# the same at --tiny's size, for a rehearsal on the CPU
SIAM_TRAIN_SMALL = dict(tiny=True, steps=6, eval_every=3, walk_eval_every=4, cpu_events=4,
                        batch=2, dp_steps=2)
# phase 9, the card against the CPU: loss (relative), channels (of their largest), gradients
# by group (of each group's largest) in float64 on both sides and in float32: on an H100 the
# trainer read 1.1e-5 to 2.8e-5 in float32, a backward in TF32 3.7e-4 to 1.7e-3 in each group
# (python3 tools/siam_tf32.py)
SIAM_TRAIN_TOL = dict(loss=1e-4, channels=1e-4, gradients64=1e-8, gradients32=1e-4)
# phase 10(d), mptpu's learned-atom MP on JAX-CPU from the port's seed-0 atoms: each Adam
# step's loss by learning rate (python3 tests/reference/mp_model_lr.py --lrs 1e-2,1e-3 and,
# for the small rehearsal, --small --steps 6). At these widths mptpu's loss rises at lr 1e-2,
# the rate of its test at 8 atoms x 32 samples, and falls at lr 1e-3
MP_FULL = {
    1e-2: [5.87476, 843.742, 92.6128, 181.86, 766.438, 492.937, 227.035, 77.3154, 235.803,
           234.401, 326.986, 254.877, 152.061, 77.0889, 109.525, 113.872, 86.4912, -34.2722,
           60.3127, 61.3481],
    1e-3: [5.87476, -14.1611, -37.2402, -64.9946, -80.7842, -77.584, -74.582, -82.6477,
           -97.6365, -111.406, -119.994, -124.781, -129.159, -135.006, -141.848, -147.759,
           -151.045, -153.1, -156.442, -161.668]}
MP_SMALL = {
    1e-2: [-2.43187e-05, -0.000540257, -0.00201845, -0.00513601, -0.0105925, -0.0191584],
    1e-3: [-2.43187e-05, -3.95775e-05, -6.05583e-05, -8.63075e-05, -0.000120163, -0.000163078]}
# phase 10, the models on ported layers (ROADMAP A10): scripts/songsplat.py's reference
# configuration (a 2^19-sample song, 2^15-sample segments, 8 events a second: 190 events over
# 2,048 frames, a range-query capacity of 32; Adam at lr 1e-3) for 5 + 100 steps, one step on
# the card against the CPU at a window where ``dense`` events are planted in range; the
# instrument over the SIAM model at sw6's shapes (2^17 samples, 32 events, hidden 128,
# context 32, STFT 2048/256): 5 random notes, then 7 notes of a bank harvested from the first
# window of scripts/codec_rate.py's segment (262,144 samples, 24 events, seed 3);
# scripts/build_index.py's defaults (32 chunks of 16,384 samples from the demo corpus, 6 bands
# of 64 atoms x 128 taps, 8 steps), 4 chunks on the CPU; the learned-atom MP at BASELINE.md's
# greedy MP demo configuration (128 atoms x 1,024 samples, a 2^15-sample signal, 25
# iterations; the reference's mp.py:92), batch 1, 20 Adam steps at lr 1e-2 and at 1e-3
MODELS = dict(
    songsplat=dict(tiny=False, warmup=5, steps=100, dense=40),
    instrument=dict(n_samples=2**17, n_events=32, hidden=128, context_dim=32, window=2048,
                    walk_samples=262144, audio_events=24),
    index=dict(chunks=32, chunk_size=16384, cpu_chunks=4),
    mp=dict(n_atoms=128, atom_samples=1024, n_samples=2**15, iterations=25, falls_at=1e-3,
            reference=MP_FULL))
# the same at small sizes, for a rehearsal on the CPU
MODELS_SMALL = dict(
    songsplat=dict(tiny=True, warmup=1, steps=12, dense=12),
    instrument=dict(n_samples=2**13, n_events=4, hidden=32, context_dim=16, window=512,
                    walk_samples=2**14, audio_events=8),
    index=dict(chunks=12, chunk_size=2048, cpu_chunks=2),   # the twelfth is the first not silent
    mp=dict(n_atoms=8, atom_samples=32, n_samples=512, iterations=3, falls_at=1e-3,
            reference=MP_SMALL))
# phase 10, the card against the CPU: losses (relative), audio and channels (of their
# largest), gradients by group (of each group's largest) in float64 on both sides and, where
# float32 is not noise (the song splat's event vectors and heads), in float32; the song
# splat's times, its reverb and the learned atoms' float32 gradients are printed; the learned
# MP's Adam losses against mptpu's trajectory, of the target feature's l1 norm (the port on
# the CPU reads 1.5e-5 at full width, 1.6e-7 small: tests/reference/mp_model_lr.py)
MODELS_TOL = dict(loss=1e-4, audio=1e-4, gradients64=1e-8, gradients32=1e-3, embedding=1e-4,
                  trajectory=1e-4)
# phase 11, the long-tail models (ROADMAP A11): mptpu's losses a step from the port's seed-0
# parameters and the same draws, on JAX-CPU (python3 tests/reference/<model>_trajectory.py;
# roomsim, textural and funcsong at their scripts' defaults, the operator at 2^13 samples and
# the script's other widths, since its 2^15 takes some 12 GiB a package on the CPU)
LONGTAIL_REFERENCE = {
    "roomsim": [0.00348664, 0.0333479, 0.00798386, 0.0112439, 0.012491, 0.00997293, 0.00734712,
                0.00556996, 0.00450103, 0.00402454, 0.00393553, 0.00385491, 0.00350677,
                0.00291676, 0.00230956, 0.00187895, 0.00166089, 0.00156605, 0.00148665,
                0.00137142],
    "textural": [3771.09, 3771.06, 3771.03, 3770.98, 3770.92, 3770.84, 3770.76, 3770.66, 3770.55,
                 3770.44, 3770.3, 3770.14, 3769.97, 3769.78, 3769.57, 3769.34, 3769.09, 3768.82,
                 3768.53, 3768.21],
    # the first 10 steps of funcsong_trajectory.py's 20: mptpu's float32 run, and the frozen
    # control (the seed-0 model on the same crops, no update) that its rise is read against
    "funcsong": [1996400.0, 2043680.0, 2093990.0, 2109380.0, 2140010.0, 2143310.0, 2154240.0,
                 2160560.0, 2198630.0, 2216160.0],
    "funcsong_control": [1999010.0, 2005320.0, 1996030.0, 2000220.0, 1993730.0, 1996000.0,
                         1995840.0, 2000140.0, 1991910.0, 1993820.0],
    "operator_random": [-0.00424888, 0.40029, -0.0250328, -0.00905275, 0.0123024, 0.0402766,
                        -0.00949427, -0.0501565, -0.0187325, 31.1757],
    "operator_overfit": [-0.00340325, 13.3763, -0.000431776, -0.0, -0.0217872, -0.0013997,
                         -0.00267279, -0.00483775, -0.0106047, -0.0262583]}
# the same at the rehearsal sizes (--smoke, and roomsim_trajectory.py --small)
LONGTAIL_REFERENCE_SMALL = {
    "roomsim": [0.0312445, 0.0215076, 0.0146056, 0.0109744, 0.00854039, 0.00666206],
    "textural": [58.6803, 58.6774, 58.6735, 58.6687, 58.6629, 58.656],
    "funcsong": [25219.7, 25160.9, 25626.7, 25660.5],
    "funcsong_control": [25097.8, 25233.6, 25194.1, 25440.1],
    "operator_random": [-5.71765e-08, -0.0, -0.0, -0.0],
    "operator_overfit": [-0.0, -5.17368e-05, -0.000218868, -0.000611007]}
# phase 11 at the scripts' defaults: scripts/roomsim.py (block 64, 512 frames, a 5 x 17 x 9
# room; its overfit at 5 x 5, lr 1e-2), scripts/textural.py (2^16 samples, 64 events, 64 x
# 2,048 atoms, latent 16), scripts/funcsong.py (a 30 s song, crops of 2^15, batch 4, 256
# position channels, hidden 256, 4 layers, 64 resonances), scripts/audiooperator.py (2^15
# samples, 512 bands, model 512, latent 64, envelope 128, batch 4, pool 512 / 128), each for
# as many steps as mptpu's trajectory has (the operator's at 2^13 samples, a run of its own)
LONGTAIL = dict(
    room=dict(block=64, frames=512, width=5, height=17, depth=9, room=5, steps=20, lr=1e-2),
    textural=dict(smoke=False, steps=20),
    funcsong=dict(smoke=False, steps=10, control=True),
    operator=dict(smoke=False, steps=10, reference_samples=2**13),
    reference=LONGTAIL_REFERENCE)
LONGTAIL_SMALL = dict(
    room=dict(block=16, frames=32, width=5, height=5, depth=5, room=3, steps=6, lr=1e-2),
    textural=dict(smoke=True, steps=6),
    # at --smoke the loss does not move off the untrained model's within the run, in mptpu
    # too (tests/reference/funcsong_trajectory.py --smoke --steps 12: the frozen control 3.1e-2
    # of mptpu's largest loss from its trajectory, the four sound runs 2.9e-2 to 4.3e-2): the
    # rehearsal prints the rise over the control and cannot gate on it; the card's run does
    funcsong=dict(smoke=True, steps=4, control=False),
    operator=dict(smoke=True, steps=4, reference_samples=2**11),
    reference=LONGTAIL_REFERENCE_SMALL,
    # the smoke operator's losses are float32 rounding of a difference of two sums of about
    # 7.0 (mptpu's random-batch ReLU head dies after one step there too; its largest loss is
    # 5.7e-8): the random batches are held within 20 times that (1.1e-6, two places of 7.0; the
    # port on the CPU read 3.1), the --overfit steps, which fall to -6.1e-4, within 1e-2 of
    # their largest (the port on the CPU read 7.8e-4)
    tol=dict(operator_random_trajectory=20.0, operator_overfit_trajectory=1e-2,
             funcsong_trajectory=0.1))
# phase 11's gates, each set from a CPU measurement before the first run on a card:
# - the room's recording and frames, card against CPU, of their peak (the port against mptpu
#   on the CPU: 3e-8);
# - one step card against CPU: the loss (relative; the operator's against the sum of its terms,
#   the target's pooled norms, since it is their difference) and float64 gradients (of each
#   parameter's largest), as for the other models; the float64 loss within gradients64;
# - funcsong's: its oscillators' phases reach 3e5 rad and move by 3.5e5 rad per unit of
#   tension, so float32 keeps no digit of them, and one float64 place of every tension moves
#   the float64 gradients by 2.1e-3 of the worst parameter's largest (median 1.3e-3;
#   tests/reference/funcsong_trajectory.py at the script's widths): two devices, which round
#   the phases otherwise, hold their float64 gradients within 1e-3 and their float32 losses
#   within 1e-2 (the port's float32 first loss 4.2e-4 from its float64);
# - a trajectory within 1e-4 of mptpu's largest loss (the port on the CPU: roomsim 1.1e-7,
#   textural 4.5e-7, the operator's --overfit 5.0e-6); the operator's random batches, whose
#   loss leaps to 31 at the tenth step, within 2e-2 (the CPU read 6.8e-3 at that step);
# - funcsong's trajectory, which no other run can follow step by step: Adam's first steps are
#   about lr times the gradient's sign, and the signs of the gradients near 0 are rounding,
#   so runs part after one step (funcsong_trajectory.py, from one init and the same batches:
#   mptpu's float64 run, the port's float32 and float64 runs, 7.0e-2, 5.7e-2 and 4.4e-2 of
#   mptpu's float32 run's largest loss from it over 10 steps, 0.28 to 0.68 over 20; the frozen
#   control 0.10, between them). Held two ways over 10 steps: each step within 0.15 of mptpu's
#   largest loss (against a blow-up), and the rise over the frozen control on the same crops
#   (the median over the last half of the steps of loss / control, less 1) within 1/4 to 3
#   times mptpu's: mptpu's float32 run rises 0.080, its float64 run 0.119, the port's 0.128 and
#   0.127, the card's float32 run before this gate 0.043 (PR 12's call 5); the control 0;
# - the A4 layers, card against CPU in float64, of each tensor's largest
LONGTAIL_TOL = dict(room=1e-5, loss=1e-5, gradients64=1e-10, funcsong_loss=1e-2,
                    funcsong_gradients64=1e-3, trajectory=1e-4,
                    operator_random_trajectory=2e-2, funcsong_trajectory=0.15,
                    funcsong_rise=(0.25, 3.0), layers=1e-10)
# phase 12, the perceptual stack, the remaining losses and the resonance chain (ROADMAP A5,
# A6): mptpu's losses a step on JAX-CPU from the port's seed-0 parameters or start and the same
# draws (python3 tests/reference/{resonance,phaseinvariance,texture}_trajectory.py): the
# resonance overfit at its script's defaults (2^15 samples, step i's impulse noise
# fold_in(PRNGKey(0), i)'s draw, kept in tests/reference/resonance_noise.npy), the three
# phase-invariance transforms at 2^17 samples, the texture features at 2^17 samples and the
# scattering features at --tiny (2^12 samples, 16 filters: at 2^17 their (64, 64, 2^17)
# convolution and its backward take JAX on the CPU far longer than minutes); the resonance and
# texture targets synthetic_audio(n, 22050, n_events=max(4, n / 22050 * 8), seed=9 and 5), since
# the scripts' corpus segments depend on the order in which a machine lists the corpus
PERCEPTUAL_REFERENCE = {
    # mptpu's loss falls within these 30 steps (medians of the first and last 7: 5507.042 ->
    # 5506.969), where the frozen seed-0 model reads 5507.071 to 5507.072 at every draw
    "resonance": [5507.07, 5507.07, 5507.04, 5506.99, 5507.04, 5506.94, 5506.85, 5507.02, 5506.99,
                  5507.04, 5507.05, 5507.02, 5507.0, 5507.05, 5507.05, 5507.06, 5507.04, 5507.05,
                  5507.05, 5507.03, 5507.04, 5507.05, 5507.04, 5507.02, 5506.94, 5506.98, 5506.97,
                  5507.0, 5506.65, 5506.79],
    # each step's loss the float64 mean of mptpu's float32 squared differences (XLA's float32
    # mean of the AIM's reads up to 1.8e-5 low; the step does not feel it)
    "phase_mag_spec_512": [0.00467745, 0.0041565, 0.00368201, 0.00324891, 0.00285886, 0.00251158,
                           0.00220532, 0.00193745, 0.00170487, 0.00150421, 0.00133197,
                           0.00118465, 0.00105895, 0.000951805, 0.000860461, 0.000782451,
                           0.000715617, 0.000658102, 0.000608324, 0.000564943],
    "phase_mag_spec_2048": [0.00468009, 0.00416589, 0.00369954, 0.0032768, 0.00289912,
                            0.00256539, 0.00227318, 0.00201917, 0.0017997, 0.00161109, 0.0014497,
                            0.00131212, 0.00119517, 0.00109592, 0.00101174, 0.000940286,
                            0.000879467, 0.00082745, 0.000782616, 0.000743619],
    "phase_aim": [598.876, 506.165, 429.652, 370.754, 325.834, 291.047, 263.872, 242.316, 224.623,
                  209.348, 195.599, 183.057, 171.66, 161.363, 152.09, 143.754, 136.314, 129.748,
                  123.99, 118.916],
    "texture_texture": [6992180000.0, 4658280000.0, 3206950000.0, 2313490000.0, 1761680000.0,
                        1417010000.0, 1198570000.0, 1057510000.0, 964519000.0, 902080000.0,
                        859600000.0, 829395000.0, 807068000.0, 789784000.0, 775881000.0,
                        764392000.0, 754310000.0, 744959000.0, 735780000.0, 726539000.0],
    "texture_scattering_tiny": [24010.7, 18597.7, 15205.9, 12707.5, 11297.7, 9970.94, 8877.75,
                                8088.8, 7512.1, 7002.89, 6374.21, 5854.09, 5487.94, 5105.09,
                                4858.9, 4540.31, 4337.54, 4164.8, 3985.22, 3758.6]}
# the same at the rehearsal sizes (--tiny, --smoke)
PERCEPTUAL_REFERENCE_SMALL = {
    "resonance": [844.938, 844.937, 844.934, 844.93],
    "phase_mag_spec_512": [0.00397862, 0.00350505, 0.00308877, 0.00272084],
    "phase_mag_spec_2048": [0.00331602, 0.00288852, 0.00251818, 0.00219451],
    "phase_aim": [202.198, 169.899, 145.13, 125.908],
    "texture_texture_tiny": [2144160.0, 1369370.0, 901799.0, 623539.0],
    "texture_scattering_tiny": [24010.7, 18597.7, 15205.9, 12707.5]}
# phase 12 at the scripts' defaults: scripts/resonance_overfit.py (2^15 samples, 128 f0s, depth
# 2, lr 1e-3), scripts/phaseinvariance.py (2^17 samples, lr 1e-2, three transforms),
# scripts/texture.py (2^17 samples, 64 filters, lr 1e-3; the scattering features also at --tiny,
# where mptpu's trajectory is), each for as many steps as mptpu's trajectory has
PERCEPTUAL = dict(
    resonance=dict(tiny=False, steps=30),
    phase=dict(n_samples=2**17, steps=20),
    texture=dict(tiny=False, steps=20),
    scattering=dict(tiny=False, steps=20, reference_tiny=True),
    reference=PERCEPTUAL_REFERENCE)
PERCEPTUAL_SMALL = dict(
    resonance=dict(tiny=True, steps=4),
    phase=dict(n_samples=2**13, steps=4),
    texture=dict(tiny=True, steps=4),
    scattering=dict(tiny=True, steps=4),
    reference=PERCEPTUAL_REFERENCE_SMALL)
# phase 12's gates, each set from a CPU measurement before the first run on a card:
# - one step card against CPU: the loss within 1e-5 of it; the float64 gradients (of each
#   parameter's largest) and loss within 1e-10, as for the other models;
# - a trajectory within 1e-5 of mptpu's largest loss (the port on the CPU from the same
#   parameters and draws: resonance 8.0e-7 over 30 steps at 2^15, where a frozen model stands
#   up to 7.6e-5 away, and the two CPU runs part from step 31 on, 4.9e-6 there and 6.9e-5 at
#   step 56; texture 9.2e-8); the
#   phase-invariance transforms within 3e-5 (the port read 2.7e-6, 2.6e-6 and 2.0e-6 at 2^17;
#   a frozen start stands 0.88 away by step 20); the scattering features at --tiny within 1e-3:
#   a near tie in max_norm's maximum sends the runs apart from step 5, and the port's float32
#   and float64 runs both stand 2.0e-4 and 1.8e-4 from mptpu's float32 one by step 20 (a frozen
#   start 0.84);
# - the scattering features at 2^17, where mptpu has no trajectory: the first loss within 1e-5
#   of the CPU's forward, a fall, and one float32 step's gradient card against CPU within 1e-4
#   of its largest, the tests' float32 gradient tolerance (python3 tools/scattering_precision.py:
#   the CPU's float32 gradient stands 3.7e-7, 7.5e-6 and 1.8e-7 from its float64 one at 2^12,
#   2^13 and 2^14 samples, 64 filters; an abs kink's side flipped by rounding makes the 2^13
#   outlier);
# - the A5 modules, card against CPU in float64, of each tensor's largest
PERCEPTUAL_TOL = dict(loss=1e-5, gradients64=1e-10, trajectory=1e-5, phase_trajectory=3e-5,
                      scattering_trajectory=1e-3, scattering_gradients32=1e-4, modules=1e-10)
# phase 13, the rest of the gen/ zoo, the energy overfit and the two trainers (ROADMAP A9a):
# mptpu's losses a step on JAX-CPU from the port's seed-0 instrument and the script's amplitudes
# (python3 tests/reference/energy_trajectory.py [--tiny]) on synthetic_audio(n, 22050,
# n_events=max(4, n / 22050 * 8), seed=5), which stands in for the script's corpus segment
ENERGY_REFERENCE = [1896.86, 1897.69, 1896.88, 1896.06, 1895.01, 1893.5, 1891.54, 1891.73,
                    1887.94, 1886.69, 1880.54, 1880.34, 1863.26, 1879.73, 1869.86, 1871.39,
                    1848.05, 1862.23, 1850.04, 1854.8, 1837.01, 1853.74, 1833.43, 1848.28,
                    1829.45, 1840.29, 1826.11, 1830.16, 1827.01, 1821.48, 1824.82, 1818.09,
                    1821.48, 1812.7, 1817.99, 1809.87, 1812.3, 1804.59, 1805.54, 1802.67,
                    1794.69, 1801.3, 1793.94, 1778.66, 1793.1, 1821.47, 1768.44, 1816.89,
                    1780.52, 1764.58, 1806.58, 1760.04, 1797.1, 1763.5, 1812.1, 1797.68,
                    1775.72, 1789.16, 1761.28, 1791.31, 1781.73, 1767.84, 1774.83, 1755.41,
                    1762.94, 1754.39, 1753.0, 1759.31, 1747.47, 1762.4, 1746.51, 1749.41,
                    1755.67, 1743.96, 1746.25, 1752.66, 1742.36, 1745.22, 1750.72, 1741.0,
                    1750.14, 1743.2, 1741.08, 1748.75, 1739.03, 1742.46, 1746.16, 1737.69,
                    1745.4, 1742.14, 1736.89, 1743.09, 1738.63, 1736.06, 1737.62, 1737.07,
                    1735.86, 1734.71, 1735.29, 1737.87]
ENERGY_REFERENCE_SMALL = [16.7574, 16.7556, 16.7543, 16.7526]
# the widths of phase 13, each with its source:
# - energy: scripts/energy_overfit.py:44-45 (2^15 samples, block 512, 128 channels, 3 layers),
#   :57 (16 impulse sites), :61-63 (Adam lr 1e-3), --disc-weight 0.1 (:38); 100 of its 500 steps
# - the SIAM-family decoders (rows 11 to 13 of the port's table) at SIAM's decoder widths
#   (mptpu/models/siam.py:215-229 and scripts/siam_overfit.py: 2^17 samples, 512 frames, context
#   32, 4,096 items or resonances, one event, batch 1); the class defaults otherwise:
#   WavetableModel 16,384 wavetable samples from band 512, 128 deformations (expressivity 8, the
#   decoder's instr_expressivity), FFTResonanceLookup window 2,048, MultibandResonanceLookup out
#   16,384, SimpleEventGenerator 128 channels (the decoder's hidden width); ConvImpulse takes the
#   resonance overfit's resonance size, 2^15 (scripts/resonance_overfit.py), and impulse 4,096;
#   SampleResonanceLookup's items are 2^15 samples long (at 2^17 its 4,096 items would be 2 GiB
#   in float32 and 4 GiB in float64 on each side, for a table that no decoder uses at that size)
# - the rest at 2^15 samples, 22,050 Hz: RedsLikeModel's defaults (64 octaves; 4,096 wavetables),
#   8 atoms; WaveguideSynth's (512 delays); waveguide_synth_scan and goo.simulate over 2^15
#   samples / steps (string_mesh(32), pluck_forces at mass 8: tests/test_gen_extra.py:14-15),
#   timed at 2^15 on the card and held card against CPU over their first 4,096 (cut: each is a
#   Python loop of some 5 to 18 launches a sample, 2.8 and 8.2 s a forward on the card, and the
#   four float32 and float64 forwards and backwards at 2^15 took 32 to 40 s a case);
#   the widths of tests/test_gen_extra.py scaled to 2^15 samples: TransferFunctionSegmentGenerator
#   (model 16, window 512, 128 frames; :49-56 has 16, 64, 8 at 256 samples), RecurrentSynth (2
#   layers, 16 channels, 16 frames of 2,048 samples; :23-31 has 4 of 64), and for the modules
#   mptpu tests at no size: AudioModel (model 16, 64 frames, 128 noise frames), InstrumentStack
#   (encoding 32, 16 channels, 128 frames, shape 8, 2 layers), MultiSSM (control 32, 512 frames,
#   state 128, window 512, 4,096 planes)
# - the GAN: tests/test_models.py:466-495 at 2^15 samples (2 events, context 8; discriminator
#   window 256, step 128, 16 channels), Adam lr 1e-4
ZOO = dict(energy=dict(tiny=False, steps=100, runner_steps=5), n=2**15, siam_n=2**17,
           siam_frames=512, context=32, items=4096, sample_items_len=2**15, reds_atoms=8,
           scan_trace=512, scan_compare=4096, reference=ENERGY_REFERENCE, gan_n=2**15)
# the rehearsal's: --tiny, and every width cut to a few thousand samples
ZOO_SMALL = dict(energy=dict(tiny=True, steps=4, runner_steps=3), n=2**11, siam_n=2**12,
                 siam_frames=16, context=8, items=64, sample_items_len=2**11, reds_atoms=2,
                 scan_trace=64, scan_compare=256, reference=ENERGY_REFERENCE_SMALL,
                 gan_n=2**11)
# phase 13's gates, each set from a CPU measurement before the first run on a card:
# - the energy trajectory within 1e-5 of mptpu's largest loss over its first 12 steps: runs that
#   differ only in rounding part within the 100 steps (python3 tests/reference/energy_trajectory.py
#   and the same run on 1 thread and in float64: the port on the CPU from mptpu at step 13, 1.5e-5
#   there; the port on 1 thread from itself on 2 at step 47; the port in float64 from mptpu's
#   float32 at step 8), and stand 1.1e-2 to 3.1e-2 of it apart by step 100; the frozen control
#   (the untrained instrument: 1896.86 at every step) stands 8.5e-2 of it away; so all 100 steps
#   within 0.05, between the two, the control checked to stand outside it, and a fall (mptpu's
#   medians of the first and last 25: 1879.73 -> 1741.08);
# - one step card against CPU: the float32 loss within 1e-5, the float64 loss and gradients
#   within 1e-10, as in phases 11 and 12;
# - each generator's float32 forward card against CPU within 1e-5 of its peak (FFTs and matrix
#   products of float32 on both), within 1e-2 where a running sum of phase over 2^15 samples or
#   more is taken (the recurrent synth, the oscillator banks: torch.cumsum sums in float64 on the
#   CPU and by a scan tree on a card, where float32 keeps about 2e-3 rad at 1e4 rad); its float64
#   forward and gradients within 1e-10 of each tensor's largest; within 1e-3 where a running
#   sum over frames is taken: of phase in the two transfer-function lookups (to 400 and 1,600
#   rad) and the two event variants (512 frames), of log-decays in the REDS model's envelopes
#   (128 frames, down to exp(-500)). Set after runs on an H100 read the FFT lookup's
#   float32 2.13e-5 of its peak card against CPU (float64 2.2e-16) and the REDS model's 1.28e-4
#   (float64 1.0e-12), against the 1e-5 first set for them: torch.cumsum sums in other orders on
#   the two devices, and float32 keeps 3e-5 rad at 400 rad; the phase-sum synths' float64
#   forward and gradients within 1e-8: torch.cumsum's two orders of float64 additions over 2^15
#   samples of phase up to 1e4 rad (an ulp 1.8e-12) part by up to n ulp / 2 = 3e-8 rad, by about
#   sqrt(n) ulp / 2 = 1.6e-10 on a random walk, and an H100 run read the recurrent synth's
#   float64 forward 1.36e-9 of its peak off the CPU;
# - the GAN's two steps in float64 card against CPU within 1e-10: losses, new parameters (of each
#   tensor's largest) and Adam's first moments (of each player's largest: set after an H100 run
#   read the discriminator's biases 4.6e-10 of their own largest from the CPU, where two
#   float64 CPU runs on 1 and 4 threads stand 2.3e-10 to 4.2e-10 apart); the generator's times
#   printed beside the CPU's own spread on 1 thread against all, and not held: some levels of the
#   binary-tree dirac take FFT round-off for their gradient (CPU runs on 1 and 4 threads: 4.4e-3,
#   6.5e-3 and 4.0e-2 of the generator's largest first moment at 2^13, 2^14, 2^15, whatever the
#   render's scale or a discriminator trained 3 or 10 steps first; at 2^12 the CPU agrees with
#   itself but an H100 run read the card 1.8e-3 off, and the discriminator's moments 9.1e-8);
#   the runner's resume bit for bit
ZOO_TOL = dict(trajectory=1e-5, trajectory_steps=12, spread=0.05, loss=1e-5, gradients64=1e-10,
               forward32=1e-5, phase32=1e-2, phase64=1e-8, frame_sum32=1e-3, gan=1e-10)
# the probe's kinds: label -> (kind, programmatic)
PROBE_KINDS = {"grid": ("grid", False), "grid chained": ("grid", True), "fori": ("fori", False)}
HOLD_CYCLES = 20_000_000   # about 10 ms of device spinning ahead of a timed run
# the probe on the device clock: launches a timed call enqueues behind a
# device spin of PROBE_HOLD_CYCLES (about 50 ms), which the host must have
# queued before the spin ends; on an H100 CUDA's launch queue held 512 such
# launches, not 1,024, and a host blocked on a full queue sets the pace again
PROBE_QUEUED = 512
PROBE_HOLD_CYCLES = 100_000_000

# published peaks without tensor cores (NVIDIA data sheets): bytes/s, f32 FLOP/s
PEAKS = {"H100 PCIe": (2.0e12, 51e12), "H100 NVL": (3.9e12, 60e12), "H100": (3.35e12, 67e12)}

# tolerances: the tail dot products are the only sums whose order differs
# between a kernel and its plain version (512-term float32 sums)
TAIL_TOL = dict(rtol=1e-4, atol=1e-4)
VALUE_TOL = dict(rtol=1e-4, atol=1e-5)     # tests/test_fast_mp.py:82-87
RESIDUAL_TOL = dict(rtol=1e-3, atol=1e-5)


def fail(msg: str) -> None:
    raise AssertionError(msg)


def planted_signal(cfg, seed: int = 1):
    """(dictionary, signal): per item, n_steps + 20 overlapping interior
    plants (distinct atoms where there are enough) with geometrically falling amplitudes, and
    one clipped plant of ``clip_taps`` taps (300 unless ``cfg`` says
    otherwise) whose atom runs on past the end (the largest event on even
    items, so the first step clips there)."""
    rng = np.random.default_rng(seed)
    N, A, n, B = cfg["n_atoms"], cfg["atom_size"], cfg["n_samples"], cfg["batch"]
    d = rng.standard_normal((N, A)).astype(np.float32)
    du = d / (np.linalg.norm(d, axis=-1, keepdims=True) + 1e-8)
    sig = np.zeros((B, 1, n), np.float32)
    n_plants = cfg["n_steps"] + 20
    for i in range(B):
        atoms = rng.choice(N, n_plants, replace=n_plants > N)
        pos = rng.integers(0, n - A, n_plants)
        for k in range(n_plants):
            sig[i, 0, pos[k] : pos[k] + A] += du[atoms[k]] * (10.0 * 0.97**k)
        inside = min(cfg.get("clip_taps", 300), A - 1)
        sig[i, 0, n - inside :] += du[rng.integers(N), :inside] * (20.0 if i % 2 == 0 else 6.0)
    return d, sig


def sines_signal(n: int, rng):
    """Three decaying sines plus noise from ``rng``, max-normed float32
    (scripts/multiband_bench.py:49-55); the splat overfit's target."""
    t = np.arange(n) / 22050.0
    sig = sum(np.sin(2 * np.pi * f * t) * np.exp(-t * d)
              for f, d in [(220, 1.0), (880, 2.0), (3520, 4.0)])
    sig = sig + 0.1 * rng.standard_normal(n)
    return (sig / np.abs(sig).max()).astype(np.float32)


def multiband_signal(mb):
    """scripts/multiband_bench.py:49-59: ``sines_signal`` tiled over the
    batch with a little noise per item."""
    rng = np.random.default_rng(0)
    sig = sines_signal(mb["n_samples"], rng)
    batch_np = np.tile(sig[None, None, :], (mb["batch"], 1, 1))
    batch_np += 0.01 * rng.standard_normal(batch_np.shape).astype(np.float32)
    return batch_np


def bench_inputs(cfg):
    """bench.py:141-143."""
    rng = np.random.default_rng(0)
    d = rng.standard_normal((cfg["n_atoms"], cfg["atom_size"])).astype(np.float32)
    sig = rng.standard_normal((cfg["batch"], 1, cfg["n_samples"])).astype(np.float32)
    return d, sig


def learning_block(atom_size: int) -> int:
    """The block at which ``dictionary_learning_step`` (and so
    ``SparseCodingLoss`` and a multiband band) encodes
    (mptpu_torch/sparse/matching_pursuit.py:193)."""
    return min(512, atom_size) if atom_size >= 128 else 512


def max_err(pairs) -> float:
    return max(float((a.double() - b.double()).abs().max()) for a, b in pairs)


def assert_close(name, a, b, tol):
    import torch

    if not torch.allclose(a, b, **tol):
        fail(f"{name}: max abs err {max_err([(a, b)]):.3e} above {tol}")


def assert_events(name, a, b, with_values=True):
    import torch

    for field in (0, 1):
        if not torch.equal(a[field].cpu(), b[field].cpu()):
            diff = int((a[field].cpu() != b[field].cpu()).sum())
            fail(f"{name}: {('atoms', 'positions')[field]} differ in {diff} events")
    if with_values:
        assert_close(f"{name} values", a[2].cpu(), b[2].cpu(), VALUE_TOL)


def timed(fn, reps: int, dev, warmup: bool = True, host: bool = False):
    """Mean ms of ``fn`` over ``reps`` calls: between CUDA events on a
    card, by the host clock on the CPU (where the harness is rehearsed).
    On a card the stream is first held busy for a few milliseconds, so that
    the calls are queued before the first one starts and the events bracket
    device time back to back, not the host's pace of launching.

    ``host``: instead (the last call's result, ms between CUDA events or
    None off a card, ms by the host clock), both clocks per call over the
    same calls, with no hold ahead of them: a call's host work (the Python,
    the launches, any synchronize inside it) is part of what it costs."""
    import torch

    if warmup:
        fn()
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.synchronize(dev)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        if not host:
            torch.cuda._sleep(HOLD_CYCLES)
        start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    if on_card:
        end.record()
        torch.cuda.synchronize(dev)
    host_ms = (time.perf_counter() - t0) * 1e3 / reps
    device_ms = start.elapsed_time(end) / reps if on_card else None
    if host:
        return out, device_ms, host_ms
    return host_ms if device_ms is None else device_ms


def step_traffic(cfg, geom, positions, chain: bool, lane_table: bool = False):
    """(bytes, flops) the fused step body must move and compute for the
    events ``positions`` (steps, items): per item-step one gram row read and
    the update window read and written, and either the winner's map block
    read by the refine or, with ``lane_table``, the window blocks' lanes
    written; per clipped event the N x A x A tail product and its N x A
    write. ``chain``: the steps are one chain of a per-step kernel's
    launches, which reads each item's block-max table once (its first launch)
    and at every step the 2 x N words of the rows' maxima; otherwise the
    caller adds what its kernel reads and writes once."""
    N, A = cfg["n_atoms"], cfg["atom_size"]
    upd_w = geom.upd_blocks * geom.block
    item_steps = positions.numel()
    clipped = int((positions > geom.n_samples - A).sum())
    per = N * 2 * A + 2 * N * upd_w + (2 * N if chain else 0)
    per += N * geom.upd_blocks if lane_table else geom.block
    once = positions.shape[-1] * N * geom.n_blocks if chain else 0
    return 4 * (item_steps * per + once + clipped * N * A), 2 * N * A * A * clipped


def bound(bytes_, flops, peaks):
    t_bytes, t_ops = bytes_ / peaks[0] * 1e3, flops / peaks[1] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def assert_identical(name, triples):
    import torch

    for field, a, b in triples:
        if not torch.equal(a, b):
            differ = int((a != b).sum()) if a.shape == b.shape else -1
            fail(f"{name}: {field} not bit-identical ({differ} elements differ)")


def initial_lanes(fm, geom):
    """First lane of each block's maximum, lane-padded with zeros
    (mptpu_torch/sparse/fast_mp.py, the lane_table branch)."""
    import torch
    import torch.nn.functional as F

    lanes = torch.argmax(fm.reshape(*fm.shape[:2], geom.n_blocks, geom.block), dim=-1)
    return F.pad(lanes.to(torch.int32), (0, geom.nb_pad - geom.n_blocks))


def assert_lane_tables(name, state, geom):
    """After a lane-table encode (fm, bm, lanes, residual): lanes == argmax
    and bm == max of every real block of the final map, pad lanes 0."""
    import torch

    fm, bm, lanes, _ = state
    blocks = fm.reshape(*fm.shape[:2], geom.n_blocks, geom.block)
    pad = lanes[..., geom.n_blocks :]
    assert_identical(f"{name}: tables vs final map", [
        ("lanes", lanes[..., : geom.n_blocks].long(), blocks.argmax(-1)),
        ("bm", bm[..., : geom.n_blocks], blocks.amax(-1)),
        ("pad lanes", pad, torch.zeros_like(pad)),
    ])


def stack_events(steps):
    """Events of single steps, each (B,), stacked (n_steps, B)."""
    import torch

    from mptpu_torch.sparse import StepEvents

    return StepEvents(*(torch.stack(x) for x in zip(*steps)))


def cluster_step_check(name, state, d2, gram_p, kw, n_steps, sync, gate_tail=True):
    """``n_steps`` steps from ``state`` (fm, bm, residual) through the
    one-block step kernel launched step by step and the plain version
    (events equal after every step, state within the tail tolerance); then
    the same steps through the one-block kernel as one chain, and through
    the cluster step kernel at every cluster size, step by step and as one
    chain with and without programmatic stream serialization: events, map,
    table and residual must equal the one-block kernel's bit for bit.
    Returns (max abs err against the plain version, clipped events)."""
    from mptpu_torch.sparse import cuda_fused_step, cuda_fused_step_pipelined, fused_step_plain

    def fresh():
        return tuple(t.clone() for t in state)

    one, plain = fresh(), fresh()
    e1, n_clip = [], 0
    for step in range(n_steps):
        e1.append(cuda_fused_step(*one, d2, gram_p, gate_tail=gate_tail, **kw))
        ep = fused_step_plain(*plain, d2, gram_p, gate_tail=gate_tail, **kw)
        sync()
        assert_events(f"{name}, step {step}, one-block kernel against plain", e1[-1], ep)
        n_clip += int((ep.positions > kw["n_samples"] - kw["atom_size"]).sum())
    e1 = stack_events(e1)
    assert_close(f"{name} fm", one[0], plain[0], TAIL_TOL)
    assert_close(f"{name} bm", one[1], plain[1], TAIL_TOL)
    assert_close(f"{name} residual", one[2], plain[2], RESIDUAL_TOL)

    def same(what, ev, st):
        sync()
        assert_identical(f"{name}, {what}, against the one-block kernel step by step", [
            ("atoms", ev.atoms, e1.atoms), ("positions", ev.positions, e1.positions),
            ("values", ev.values, e1.values), ("fm", st[0], one[0]), ("bm", st[1], one[1]),
            ("residual", st[2], one[2]),
        ])

    st = fresh()
    same("one-block kernel as a chain",
         cuda_fused_step(*st, d2, gram_p, gate_tail=gate_tail, n_steps=n_steps, **kw), st)
    for c in (c for c in (1, 2, 4, 8, 16) if state[0].shape[1] % c == 0):
        st = fresh()
        ev = [cuda_fused_step_pipelined(*st, d2, gram_p, gate_tail=gate_tail, cluster=c, **kw)
              for _ in range(n_steps)]
        same(f"cluster of {c} step by step", stack_events(ev), st)
        for programmatic in (True, False):
            st = fresh()
            ev = cuda_fused_step_pipelined(*st, d2, gram_p, gate_tail=gate_tail, cluster=c,
                                           n_steps=n_steps, programmatic=programmatic, **kw)
            same(f"cluster of {c} as a chain (programmatic={programmatic})", ev, st)
    return max_err(zip(one, plain)), n_clip


def device_time_by_kernel(fn, sync):
    """({kernel name: device ms}, busy ms, kernel launches, {name: count})
    over one call of ``fn`` traced with ``torch.profiler``, the names those
    of the kernels, copies ("Memcpy DtoH (Device -> Pageable)" and the like)
    and sets; empty and 0 when the trace holds no device time. Busy time
    is the union of the kernels' intervals in the trace, not the sum of
    their durations: under programmatic stream serialization a step kernel
    starts while the step before it runs and waits inside, so its interval
    overlaps its predecessor's."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        sync()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    rows, counts, spans, n_kernels = {}, {}, [], 0
    for e in events:
        if e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        counts[e["name"]] = counts.get(e["name"], 0) + 1
        if e.get("dur", 0) > 0:
            rows[e["name"]] = rows.get(e["name"], 0.0) + e["dur"] / 1e3
            spans.append((e["ts"], e["ts"] + e["dur"]))
            n_kernels += e.get("cat") == "kernel"
    busy, end = 0.0, float("-inf")
    for t0, t1 in sorted(spans):
        if t1 > end:
            busy += t1 - max(t0, end)
            end = t1
    return rows, busy / 1e3, n_kernels, counts


def busy_line(what, traced, wall_ms):
    """One line: the device's busy time (the union of the traced kernels'
    intervals) against ``wall_ms`` and the kernels whose intervals sum to
    most."""
    rows, busy = traced[:2]
    if not rows:
        return f"{what}: device time not measured (the profiler's trace holds no device time)"
    top = sorted(rows.items(), key=lambda kv: -kv[1])[:6]
    return (f"{what}: device busy {busy:.3f} ms of {wall_ms:.3f} ms wall measured without the "
            f"profiler (idle share {max(0.0, 1 - busy / wall_ms):.2f}; the kernels' intervals "
            f"sum to {sum(rows.values()):.3f} ms, overlapping where a step starts under the one "
            f"before it); by kernel, interval ms: "
            + "; ".join(f"{name[:60]} {ms:.3f}" for name, ms in top))


def multiband_phase(dev, mb, peaks, sync, records):
    """Multiband dictionary learning at the width of
    scripts/multiband_bench.py through the model's entry points, with the
    launch counts set to 0 first and read last; then the cluster step
    kernel at the largest and smallest band's shapes against the one-block
    kernel and the plain version, and its time there."""
    import torch
    import torch.nn.functional as F

    from mptpu_torch import kernels
    from mptpu_torch.ops import fft_frequency_decompose, unit_norm
    from mptpu_torch.sparse import (
        BandSpec, MultibandDictionaryLearning, cuda_fused_encode, cuda_fused_step,
        cuda_fused_step_pipelined, dictionary_gram, encode_state, fast_geometry,
        fused_step_applicable, fused_step_plain,
        sparse_code, sparse_code_fast,
    )
    from mptpu_torch.sparse.cuda_fused_mp import step_plan

    sizes, n, steps, batch = mb["sizes"], mb["n_samples"], mb["steps"], mb["batch"]
    N, A = mb["n_atoms"], mb["atom_size"]
    block = learning_block(A)   # the band encoder's choice
    on_card = dev.type == "cuda"
    model = MultibandDictionaryLearning(
        [BandSpec(s, N, A, signal_samples=n, is_lowest_band=(s == sizes[0]), device=dev)
         for s in sizes],
        n_samples=n,
    )
    x = torch.from_numpy(multiband_signal(mb)).to(dev)
    fused_bands = [s for s in sizes
                   if fused_step_applicable(s, A, block, fast_geometry(s, A, block).pad, N, dev)]
    per_encode = len(fused_bands) * steps if on_card else 0

    def snr(recon):
        num = float((x.double() ** 2).sum())
        return 10 * np.log10(num / float(((x - recon).double() ** 2).sum()))

    def clocked(fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, (time.perf_counter() - t0) * 1e3

    kernels.reset_launches()
    (recon, _), first_ms = clocked(lambda: model.recon(x, steps))
    if tuple(recon.shape) != tuple(x.shape) or not torch.isfinite(recon).all():
        fail("multiband recon: wrong shape or non-finite values")
    snr0 = snr(recon)
    enc_ms = []
    for _ in range(3):
        before = kernels.LAUNCHES["cuda_fused_step_pipelined"]
        enc, ms = clocked(lambda: model.encode(x, steps))
        enc_ms.append(ms)
        got = kernels.LAUNCHES["cuda_fused_step_pipelined"] - before
        if got != per_encode:
            fail(f"multiband encode: {got} launches of the cluster step kernel, "
                 f"expected {per_encode}")
    for size, ev in enc.items():
        if tuple(ev.atom_indices.shape) != (steps, batch) or not torch.isfinite(ev.values).all():
            fail(f"multiband encode, band {size}: wrong event shape or non-finite values")
    enc_rows = (device_time_by_kernel(lambda: model.encode(x, steps), sync) if on_card
                else ({}, 0, 0))
    d_start = {size: band.d for size, band in model.bands.items()}
    learn_ms = [clocked(lambda: model.learn(x, steps))[1] for _ in range(mb["learn_iters"])]
    for size, band in model.bands.items():
        norms = band.d.norm(dim=-1)
        if not torch.allclose(norms, torch.ones_like(norms), atol=1e-4):
            fail(f"multiband learn, band {size}: atoms are not unit norm")
    recon, enc = model.recon(x, steps)
    snr1 = snr(recon)
    if not snr1 > snr0:
        fail(f"multiband learn: recon SNR did not rise ({snr0:.3f} -> {snr1:.3f} dB)")
    flat = model.flattened_event_tuples(model.encode(x, steps))
    decoded = model.decode_global(*flat, batch_size=batch, n_steps=steps)
    snr_rt = snr(decoded)
    if not abs(snr_rt - snr1) < 0.1:
        fail(f"multiband wire round trip: {snr_rt:.3f} dB against {snr1:.3f} dB from decode")
    sync()
    launches = dict(kernels.LAUNCHES)
    # recon, 3 encodes, 1 traced encode on a card, the learns, recon, encode
    n_encodes = 4 + int(on_card) + mb["learn_iters"] + 2
    want = {k: (n_encodes * per_encode if k == "cuda_fused_step_pipelined" else 0)
            for k in launches}
    if launches != want:
        fail(f"multiband path: {launches}, expected {want}")
    records["cuda_fused_step_pipelined"]["launches"] = launches["cuda_fused_step_pipelined"]
    ms = float(np.mean(enc_ms))
    events = steps * len(sizes) * batch
    print(f"multiband path ({len(sizes)} bands {sizes[0]}..{sizes[-1]}, {N} atoms x {A} taps, "
          f"{n} samples, {steps} steps, batch {batch}; {len(fused_bands)} bands through the "
          f"cluster step kernel): first recon {first_ms:.1f} ms, SNR {snr0:.3f} dB; encode "
          f"{ms:.3f} ms (runs {', '.join(f'{t:.3f}' for t in enc_ms)}) = {events / (ms / 1e3):.0f} "
          f"events/s, {per_encode} kernel launches per encode; learn "
          f"{', '.join(f'{t:.1f}' for t in learn_ms)} ms per iteration; SNR after "
          f"{mb['learn_iters']} iterations {snr1:.3f} dB; wire round trip {snr_rt:.3f} dB; "
          f"launches {launches}")

    if on_card:
        print(busy_line("multiband encode, traced", enc_rows, ms))
        d_end = {size: band.d for size, band in model.bands.items()}
        for size, band in model.bands.items():   # trace the first learn iteration again
            band.d = d_start[size]
        learn_rows = device_time_by_kernel(lambda: model.learn(x, steps), sync)
        for size, band in model.bands.items():
            band.d = d_end[size]
        print(busy_line("multiband learn iteration, traced", learn_rows, learn_ms[0]))

    # per band: where one encode and one learn iteration spend their time,
    # and the fused path's events against the one-block kernel's (bit for
    # bit) and the naive encoder's (on this noisy signal near-ties may flip:
    # counted, and the reconstruction error compared)
    bands = fft_frequency_decompose(x, model.min_size)
    _, dec_ms = clocked(lambda: fft_frequency_decompose(x, model.min_size))
    _, rec_ms = clocked(lambda: model.decode(enc, batch))
    print(f"multiband split: decompose {dec_ms:.3f} ms, decode (scatter + recompose) {rec_ms:.3f} ms")
    for size in sizes:
        band, sig = model.bands[size], bands[size]
        geom = fast_geometry(size, A, block)
        d2 = unit_norm(band.d)
        _, gram_ms = clocked(lambda: dictionary_gram(d2))
        _, corr_ms = clocked(lambda: encode_state(sig, d2, geom))
        ev, band_enc_ms = clocked(lambda: band.encode(sig, steps))
        d_before = band.d
        _, band_learn_ms = clocked(lambda: band.learn(sig, steps))
        band.d = d_before
        used = int(torch.unique(ev.atom_indices).numel())
        line = (f"  band {size}: encode {band_enc_ms:.3f} ms (gram {gram_ms:.3f}, correlation + "
                f"tables {corr_ms:.3f}), learn {band_learn_ms:.3f} ms ({used} atoms updated)")
        if size in fused_bands and on_card:   # on the CPU the band encoder is not fused
            one = sparse_code_fast(sig, band.d, n_steps=steps, block=block, fused=True,
                                   pipelined=False)
            assert_identical(f"band {size}: cluster path vs one-block path", [
                ("atoms", ev.atom_indices, one.atom_indices), ("positions", ev.positions,
                 one.positions), ("values", ev.values, one.values),
                ("residual", ev.residual, one.residual),
            ])
            line += "; events and residual bit-identical to the one-block path"
        naive = sparse_code(sig, band.d, n_steps=steps)
        differ = int(((naive.atom_indices != ev.atom_indices)
                      | (naive.positions != ev.positions)).sum())
        e_fast = float((ev.residual.double() ** 2).sum())
        e_naive = float((naive.residual.double() ** 2).sum())
        if not abs(10 * np.log10(e_fast / e_naive)) < 0.05:
            fail(f"band {size}: residual energy {e_fast:.6e} against naive {e_naive:.6e}")
        print(line + f"; {differ}/{steps * batch} events differ from naive sparse_code, residual "
              f"energy ratio {e_fast / e_naive:.6f}")
        del naive

    # the cluster step kernel at every fused band's shapes: a chain of one
    # encode's steps, timed with and without programmatic stream
    # serialization, beside the whole-encode kernel doing the same steps in
    # one launch; at the largest and smallest band also the checks against
    # the one-block kernel and the plain version, and the cluster-size sweep
    rec = records["cuda_fused_step_pipelined"]
    for size in reversed(fused_bands):
        sig = bands[size]
        geom = fast_geometry(size, A, block)
        kw = geom._asdict()
        cfg = dict(n_atoms=N, atom_size=A)
        d2 = unit_norm(model.bands[size].d)
        gram_p = F.pad(dictionary_gram(d2), (0, 1))
        fm, bm, res = encode_state(sig, d2, geom)
        bm = F.pad(bm, (0, geom.nb_pad - geom.n_blocks), value=-3e38)
        state = (fm, bm, res)

        def chain_ms(fn, **opts):
            """ms of one call of ``fn`` on a fresh copy of the band's state."""
            st = tuple(t.clone() for t in state)
            found = []
            ms = timed(lambda: found.append(fn(*st, d2, gram_p, **opts, **kw)), 1, dev,
                       warmup=False)
            return ms, found[0]

        chain_ms(cuda_fused_step_pipelined, n_steps=steps)   # warm-up
        k4_ms, ev = chain_ms(cuda_fused_step_pipelined, n_steps=steps)
        k4_serial_ms, _ = chain_ms(cuda_fused_step_pipelined, n_steps=steps, programmatic=False)
        chain_ms(cuda_fused_encode, n_steps=steps)
        k2_ms, ev2 = chain_ms(cuda_fused_encode, n_steps=steps)
        assert_identical(f"band {size}: whole encode vs the cluster step kernel's chain", [
            ("atoms", ev2.atoms, ev.atoms), ("positions", ev2.positions, ev.positions),
            ("values", ev2.values, ev.values),
        ])
        b_bytes, b_flops = step_traffic(cfg, geom, ev.positions, chain=True)
        bms, by = bound(b_bytes / steps, b_flops / steps, peaks)
        line = (f"time band {size} (batch {batch}, map {tuple(fm.shape)}, "
                f"{int((ev.positions > size - A).sum())} of {steps * batch} events clipped): "
                f"cuda_fused_step_pipelined {k4_ms / steps:.5f} ms per step in a chain of {steps} "
                f"({k4_serial_ms / steps:.5f} without programmatic serialization), {k4_ms:.4f} ms "
                f"per {steps} steps; cuda_fused_encode {k2_ms:.4f} ms for the same {steps} steps "
                f"in one launch; bound {bms:.5f} ms per step ({by})")
        if size not in (fused_bands[-1], fused_bands[0]):
            print(line)
            continue
        err, n_clip = cluster_step_check(f"cluster step, band {size}", state, d2, gram_p, kw, 4,
                                         sync)
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        # the whole-encode kernel takes a band's shapes too (more table
        # columns than a lane holds in registers, rows fewer than stages)
        looped, whole = (tuple(t.clone() for t in state) for _ in range(2))
        e1 = stack_events([cuda_fused_step(*looped, d2, gram_p, **kw) for _ in range(4)])
        e2 = cuda_fused_encode(*whole, d2, gram_p, n_steps=4, **kw)
        sync()
        assert_identical(f"whole encode at band {size} vs the one-block step kernel looped", [
            ("atoms", e2.atoms, e1.atoms), ("positions", e2.positions, e1.positions),
            ("values", e2.values, e1.values),
            ("fm", whole[0], looped[0]), ("bm", whole[1], looped[1]),
            ("residual", whole[2], looped[2]),
        ])
        del looped, whole
        chain_ms(cuda_fused_step, n_steps=steps)
        k1_ms, _ = chain_ms(cuda_fused_step, n_steps=steps)
        plain_ms = timed(lambda: fused_step_plain(fm, bm, res, d2, gram_p, **kw), 3, dev)
        sweep = ""
        if on_card:
            shapes = (N, A, block, geom.n_blocks, geom.upd_blocks)
            by_size = {c: chain_ms(cuda_fused_step_pipelined, n_steps=steps, cluster=c)[0] / steps
                       for c in (1, 2, 4, 8, 16)}
            sweep = "; by cluster size (ms per step, clusters resident at once): " + ", ".join(
                f"{c}: {ms:.5f} ({step_plan(*shapes, c).clusters})" for c, ms in by_size.items())
        if size == fused_bands[-1]:
            rec.update(ms=k4_ms / steps, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                       library_ms=None, ms_serial=k4_serial_ms / steps)
        else:
            rec.update(ms_smallest_band=k4_ms / steps, bound_ms_smallest_band=bms)
        print(f"check cuda_fused_step_pipelined at band {size}: clusters of 1 to 16, step by "
              f"step and as chains, bit-identical to the one-block kernel over 4 steps (and so is "
              f"cuda_fused_encode), max abs err vs plain {err:.3e}")
        print(line + f"; cuda_fused_step {k1_ms / steps:.5f} ms per step in a chain, plain "
              f"{plain_ms:.4f} ms" + sweep)


def queued_ms(fn, dev, hold_cycles=PROBE_HOLD_CYCLES):
    """(ms, ahead) of one call of ``fn`` between CUDA events, the stream
    first held busy by a device spin of ``hold_cycles``; ``ahead`` says that
    the host had enqueued all of the call's work before the spin ended, so
    that the events bracket device time alone, not the host's pace. On the
    CPU: the host clock, and ahead."""
    import torch

    if dev.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3, True
    torch.cuda.synchronize(dev)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(hold_cycles)
    start.record()
    fn()
    end.record()
    ahead = not start.query()   # the spin still runs: every launch is queued
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end), ahead


def probe_phase(dev, peaks, sync, records):
    """The launch probe, launch counts set to 0 first and read last: each
    kind timed by the host clock (calls of PROBE_STEPS, best of 3, as
    before) and on the device clock (3 calls behind a device spin, each of
    PROBE_QUEUED launches, or of one launch looping PROBE_STEPS times): us
    per launch or per loop iteration."""
    from mptpu_torch import kernels
    from mptpu_torch.probes import probe_launches, probe_plain

    kernels.reset_launches()
    host_us, dev_us, dev_ms = {}, {}, {}
    for label, (kind, programmatic) in PROBE_KINDS.items():
        queued = PROBE_STEPS if kind == "fori" else PROBE_QUEUED
        for vpu in (False, True):
            def call(steps):
                probe_launches(kind, vpu, steps, dev, programmatic=programmatic)

            best = float("inf")
            for _ in range(3):
                sync()
                t0 = time.perf_counter()
                call(PROBE_STEPS)
                sync()
                best = min(best, time.perf_counter() - t0)
            host_us[label, vpu] = best * 1e6 / PROBE_STEPS
            runs = []
            for _ in range(3):
                ms, ahead = queued_ms(lambda: call(queued), dev)
                if not ahead:
                    fail(f"probe {label}: the host had not queued {queued} launches when the "
                         f"device spin ended, so the device clock would read the host's pace")
                runs.append(ms)
            dev_ms[label, vpu] = float(np.mean(runs))
            dev_us[label, vpu] = [ms * 1e3 / queued for ms in runs]
    launches = dict(kernels.LAUNCHES)
    want = {k: (6 * 2 * len(PROBE_KINDS) if k == "probe_launches" and dev.type == "cuda" else 0)
            for k in launches}
    if launches != want:
        fail(f"probe phase: {launches}, expected {want}")
    t0 = time.perf_counter()
    probe_plain(True, PROBE_QUEUED, dev)
    sync()
    probe_plain_ms = (time.perf_counter() - t0) * 1e3
    # the record: one call of PROBE_QUEUED launches with the arithmetic
    bms, by = bound(4 * 8 * 128, 2 * 8 * 128 * PROBE_QUEUED, peaks)
    records["probe_launches"].update(
        launches=launches["probe_launches"], ms=dev_ms["grid", True], plain_ms=probe_plain_ms,
        bound_ms=bms, bound_by=by, library_ms=None, launches_per_call=PROBE_QUEUED,
        ms_programmatic=dev_ms["grid chained", True],
        us_per_launch=float(np.mean(dev_us["grid", True])),
        us_per_launch_programmatic=float(np.mean(dev_us["grid chained", True])),
        us_per_iteration_fori=float(np.mean(dev_us["fori", True])),
        us_per_launch_host_clock=host_us["grid", True],
    )
    for label, (kind, _) in PROBE_KINDS.items():
        unit = (f"iteration (one launch of {PROBE_STEPS})" if kind == "fori"
                else f"launch ({PROBE_QUEUED} a call)")
        print(f"probe {label}, us per {unit}: device clock "
              + "; ".join(f"{'with' if vpu else 'without'} the arithmetic "
                          f"{np.mean(dev_us[label, vpu]):.4f} (runs "
                          f"{', '.join(f'{u:.4f}' for u in dev_us[label, vpu])})"
                          for vpu in (False, True))
              + f"; host clock, calls of {PROBE_STEPS}, best of 3, without / with: "
              + ", ".join(f"{host_us[label, vpu]:.4f}" for vpu in (False, True)))
    print(f"probe launches {launches}")


def ms_text(device_ms, host_ms) -> str:
    dev = "not measured" if device_ms is None else f"{device_ms:.3f} ms"
    return f"{dev} (CUDA events), {host_ms:.3f} ms (host clock)"


def on_both(fn, arrays, seed, dev):
    """``fn`` on CUDA tensors and on CPU tensors made from the same numpy
    ``arrays``: (max abs err of the float outputs, of the gradients of
    ``sum(out * w)`` for a seeded ``w`` into the first array). Integer
    outputs must be equal; float outputs and gradients within VALUE_TOL
    (the gradients' atol scaled by their largest magnitude)."""
    import torch

    def call(device):
        ins = [torch.from_numpy(a).to(device) for a in arrays]
        ins[0].requires_grad_()
        outs = fn(*ins)
        outs = outs if isinstance(outs, tuple) else (outs,)
        floats = [o for o in outs if o.is_floating_point()]
        gen = torch.Generator().manual_seed(seed)
        loss = sum((o * torch.randn(o.shape, generator=gen).to(device)).sum() for o in floats)
        (g,) = torch.autograd.grad(loss, ins[0])
        return outs, g

    (o_dev, g_dev), (o_cpu, g_cpu) = call(dev), call(torch.device("cpu"))
    err = 0.0
    for i, (a, b) in enumerate(zip(o_dev, o_cpu)):
        a = a.detach().cpu()
        b = b.detach()
        if a.is_floating_point():
            assert_close(f"output {i}", a, b, VALUE_TOL)
            err = max(err, max_err([(a, b)]))
        elif not torch.equal(a, b):
            fail(f"output {i}: {int((a != b).sum())} integer entries differ")
    g_dev = g_dev.cpu()
    scale = float(g_cpu.abs().max())
    assert_close("gradient", g_dev, g_cpu, dict(rtol=VALUE_TOL["rtol"],
                                                atol=VALUE_TOL["atol"] * max(scale, 1e-30)))
    return err, max_err([(g_dev, g_cpu)])


def sparse_layer_phase(dev, cfg, records):
    """The sparse layer beside the encoder, launch counts set to 0 first
    and read last: (1) ``omp_refit`` after the bench encode through the
    whole-encode kernel; (2) ``sparse_feature_map`` and
    ``sparse_coding_loss``, forward and backward, with the backward's peak
    memory; (3) ``SparseCodingLoss`` learning through the cluster step
    kernel; (4) the STE, top-k and quantize functions on the card against
    the CPU; (5) ``sharded_sparse_code`` on a process group of one rank.
    Then, its launches not counted, (3)'s encode at the planted signal
    against the naive coder."""
    import tempfile
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    from mptpu_torch import kernels
    from mptpu_torch.ops import sparse_softmax
    from mptpu_torch.parallel import make_mesh, sharded_sparse_code
    from mptpu_torch.sparse import (
        QuantizedResonanceMixture, SparseCodingLoss, event_tracks, hard_choice, omp_refit,
        reconstruct_from_events, sparse_code, sparse_code_fast, sparse_coding_loss,
        sparse_feature_map, sparsify, sparsify2, sparsify_vectors, to_key_points,
    )

    B, N, A, n, S = (cfg[k] for k in ("batch", "n_atoms", "atom_size", "n_samples", "n_steps"))
    on_card = dev.type == "cuda"
    d_np, sig_np = planted_signal(cfg)
    d = torch.from_numpy(d_np).to(dev)
    sig = torch.from_numpy(sig_np).to(dev)
    rng = np.random.default_rng(5)
    rms = float(np.sqrt((sig_np.astype(np.float64) ** 2).mean()))
    recon = sig + torch.from_numpy((0.01 * rms * rng.standard_normal(sig_np.shape))
                                   .astype(np.float32)).to(dev)
    def once(fn):
        """(result, CUDA-event ms or None, host ms) of one call of ``fn``."""
        return timed(fn, 1, dev, warmup=False, host=True)

    kernels.reset_launches()
    t_phase = time.perf_counter()

    # 1. omp_refit after the bench encode (the whole-encode kernel)
    before = kernels.LAUNCHES["cuda_fused_encode"]
    code, enc_dev, enc_host = once(lambda: sparse_code_fast(
        sig, d, n_steps=S, block=cfg["block"], fused=True, whole_loop=True, depth=cfg["depth"]))
    if kernels.LAUNCHES["cuda_fused_encode"] - before != int(on_card):
        fail("sparse layer: the bench encode before omp_refit did not launch the whole-encode "
             "kernel once")
    _, first_dev, first_host = once(lambda: omp_refit(sig, code, d, ridge=1e-6))
    refit, ref_dev, ref_host = once(lambda: omp_refit(sig, code, d, ridge=1e-6))
    if not (torch.equal(refit.atom_indices, code.atom_indices)
            and torch.equal(refit.positions, code.positions)):
        fail("omp_refit changed atoms or positions")
    g_err = float(((sig - reconstruct_from_events(code, d)).double() ** 2).sum())
    r_recon = reconstruct_from_events(refit, d)
    r_err = float(((sig - r_recon).double() ** 2).sum())
    if not r_err <= g_err * (1 + 1e-5):
        fail(f"omp_refit: waveform error {r_err:.6e} above the greedy {g_err:.6e}")
    assert_close("omp_refit residual", refit.residual, sig - r_recon, RESIDUAL_TOL)
    # the same normal equations solved in float64 by numpy
    tracks = event_tracks(code, d, n).double()
    gram = torch.einsum("ben,bfn->bef", tracks, tracks)
    rhs = torch.einsum("ben,bn->be", tracks, sig[:, 0].double())
    lam = 1e-6 * (torch.diagonal(gram, dim1=-2, dim2=-1).sum(-1)[:, None, None] / S + 1e-12)
    want = np.linalg.solve((gram + lam * torch.eye(S, dtype=gram.dtype, device=dev)).cpu().numpy(),
                           rhs.cpu().numpy()[..., None])[..., 0].T
    got = refit.values.double().cpu().numpy()
    rel = float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-12)))
    rel_norm = float(np.abs(got - want).max() / np.abs(want).max())
    recon64 = torch.einsum("be,ben->bn", torch.from_numpy(want.T.copy()).to(dev), tracks)
    err64 = float(((sig[:, 0].double() - recon64) ** 2).sum())
    # an event picked twice (same item, atom and position) gives two equal
    # tracks: only their sum is determined, the split follows the ridge
    keys = (torch.arange(B, device=dev) * N + code.atom_indices.long()) * n + code.positions.long()
    repeats = S * B - int(torch.unique(keys).numel())
    del tracks, gram, rhs, recon64
    print(f"sparse layer 1, omp_refit after the bench encode ({B} items x {S} steps, planted): "
          f"encode {ms_text(enc_dev, enc_host)}, refit {ms_text(ref_dev, ref_host)} (first call "
          f"{ms_text(first_dev, first_host)}); events kept, waveform error {r_err:.6e} against "
          f"the greedy {g_err:.6e} (ratio {r_err / g_err:.6f}), residual = signal - "
          f"reconstruction; values against a float64 numpy solve of the same equations: largest "
          f"relative difference {rel:.3e}, largest difference over the largest value "
          f"{rel_norm:.3e}, the float64 values' waveform error {err64:.6e}; {repeats} of "
          f"{S * B} events repeat an earlier (item, atom, position)")

    # 2. the feature map and the loss at the bench width, forward and backward
    naive = sparse_code(sig, d, n_steps=S)
    with torch.no_grad():
        fm, fm_dev, fm_host = once(lambda: sparse_feature_map(sig, d, n_steps=S))
    # an event picked again at the same (item, atom, position) adds to it
    picked = torch.zeros_like(fm).index_put_(
        (torch.arange(B, device=dev).expand(S, B), naive.atom_indices.long(),
         naive.positions.long()), naive.values, accumulate=True)
    if not torch.equal(fm != 0, picked != 0):
        fail(f"sparse_feature_map: {int(torch.count_nonzero(fm))} non-zeros, not the "
             f"{int(torch.count_nonzero(picked))} events of sparse_code")
    assert_close("sparse_feature_map values", fm, picked, VALUE_TOL)
    del fm, picked
    # a small shape on the card against the port on the CPU (and the warm-up
    # of the timed call below: checkpoint's first call takes seconds)
    sd_np, ss_np = planted_signal(SMALL_LOSS)
    sr_np = ss_np + (0.01 * np.sqrt((ss_np**2).mean())
                     * rng.standard_normal(ss_np.shape)).astype(np.float32)
    small = []
    for device in (dev, torch.device("cpu")):
        r_s = torch.from_numpy(sr_np).to(device).requires_grad_()
        l_s = sparse_coding_loss(r_s, torch.from_numpy(ss_np).to(device),
                                 torch.from_numpy(sd_np).to(device), n_steps=SMALL_LOSS["n_steps"])
        small.append((l_s.detach().cpu(), torch.autograd.grad(l_s, r_s)[0].cpu()))
    assert_close("small sparse_coding_loss, card against CPU", small[0][0], small[1][0], VALUE_TOL)
    scale = float(small[1][1].abs().max())
    assert_close("small sparse_coding_loss gradient, card against CPU", small[0][1], small[1][1],
                 dict(rtol=1e-3, atol=1e-5 * scale))
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev) if on_card else 0
    rt = recon.clone().requires_grad_()
    loss, fwd_dev, fwd_host = once(lambda: sparse_coding_loss(rt, sig, d, n_steps=S))
    fwd_peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    (g,), bwd_dev, bwd_host = once(lambda: torch.autograd.grad(loss, rt))
    bwd_peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    if not (torch.isfinite(loss) and torch.isfinite(g).all() and bool((g != 0).any())):
        fail("sparse_coding_loss: non-finite loss or gradient, or a zero gradient")
    if bwd_peak >= 16 * 2**30:
        fail(f"sparse_coding_loss backward: peak {bwd_peak / 2**30:.2f} GiB, not under 16 GiB")
    memory = (f"peak memory {fwd_peak / 2**30:.3f} GiB over the forward, {bwd_peak / 2**30:.3f} "
              f"GiB over the backward (from {base / 2**30:.3f} GiB before, limit 16 GiB)"
              if on_card else "peak memory not measured")
    print(f"sparse layer 2, sparse_feature_map and sparse_coding_loss ({B} items x {N} atoms x "
          f"{n} samples, {S} steps; recon = planted + 1% noise): map {ms_text(fm_dev, fm_host)}, "
          f"its non-zeros the events of sparse_code; loss {loss.item():.6e}, forward "
          f"{ms_text(fwd_dev, fwd_host)}, backward {ms_text(bwd_dev, bwd_host)}; {memory}; "
          f"gradient |max| "
          f"{float(g.abs().max()):.3e}; at {SMALL_LOSS['n_atoms']} x {SMALL_LOSS['atom_size']}, "
          f"{SMALL_LOSS['n_samples']} samples, batch {SMALL_LOSS['batch']}: loss and gradient "
          f"on the card within {max_err([(small[0][0], small[1][0])]):.3e} "
          f"and {max_err([(small[0][1], small[1][1])]):.3e} of the CPU")
    del rt, loss, g

    # 3. SparseCodingLoss: two learning calls through the cluster step kernel
    scl = SparseCodingLoss(N, A, S, learning_steps=2, generator=torch.Generator().manual_seed(0),
                           device=dev)
    per_call = []
    for call in range(3):
        before = kernels.LAUNCHES["cuda_fused_step_pipelined"]
        with torch.no_grad():
            value, c_dev, c_host = once(lambda: scl(recon, sig))
        got = kernels.LAUNCHES["cuda_fused_step_pipelined"] - before
        want = S if call < 2 and on_card else 0
        if got != want:
            fail(f"SparseCodingLoss call {call + 1}: {got} cluster step kernel launches, "
                 f"expected {want}")
        norms = scl.d.norm(dim=-1)
        if not (torch.isfinite(value) and torch.allclose(norms, torch.ones_like(norms), atol=1e-4)):
            fail(f"SparseCodingLoss call {call + 1}: loss not finite or atoms not unit norm")
        per_call.append(f"call {call + 1}: loss {float(value):.6e}, {got} launches, "
                        f"{ms_text(c_dev, c_host)}")
    print(f"sparse layer 3, SparseCodingLoss({N}, {A}, {S}, learning_steps=2): "
          + "; ".join(per_call))
    del scl

    # 4. STE, top-k and quantize on the card against the CPU
    def normal(shape, seed):
        return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)

    x = normal((8, 512, 1024), 11)
    quant = {where.type: QuantizedResonanceMixture(512, 16, 2**15, 22050,
                                                   generator=torch.Generator().manual_seed(3),
                                                   device=where)
             for where in (dev, torch.device("cpu"))}
    checks = [
        ("sparsify k=64", lambda v: sparsify(v, 64), [x]),
        ("sparsify k=64 soft", lambda v: sparsify(v, 64, soft=True), [x]),
        ("sparsify k=64 sharpen", lambda v: sparsify(v, 64, sharpen=True), [x]),
        ("sparsify2 k=64", lambda v: sparsify2(v, 64), [x]),
        ("sparsify_vectors k=64", lambda v, a: sparsify_vectors(v, a, 64), [x, normal((8, 1024), 12)]),
        ("to_key_points k=64", lambda v: to_key_points(v, 64), [np.abs(normal((8, 256, 256), 13))]),
        ("sparse_softmax", sparse_softmax, [x]),
    ] + [
        (f"hard_choice {kind}", lambda v, kind=kind: hard_choice(v, kind), [x])
        for kind in ("sparse_softmax", "identity", "softmax", "relu")
    ] + [
        ("QuantizedResonanceMixture(512, 16, 2**15, 22050)",
         lambda v: quant[v.device.type](v, return_code=True), [normal((4, 16, 512), 14)]),
    ]
    errs = []
    for name, fn, arrays in checks:
        err, g_err = on_both(fn, arrays, 21, dev)
        errs.append(f"{name} {err:.1e}/{g_err:.1e}")
    sel = torch.from_numpy(x).to(dev)
    gumbel = hard_choice(sel, "gumbel_softmax",
                         generator=torch.Generator(device=dev).manual_seed(4))
    if not (bool((torch.count_nonzero(gumbel, dim=-1) == 1).all())
            and torch.allclose(gumbel.sum(-1), torch.ones_like(gumbel.sum(-1)))):
        fail("hard_choice gumbel_softmax: not one-hot")
    print("sparse layer 4, on the card against the CPU, max abs err of outputs / gradients: "
          + ", ".join(errs) + "; hard_choice gumbel_softmax one-hot")
    del quant, sel, gumbel

    # 5. sharded_sparse_code on a process group of one rank
    backend = "nccl" if on_card else "gloo"
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(backend, store=dist.FileStore(f"{tmp}/store", 1), rank=0,
                                world_size=1, timeout=timedelta(seconds=60))
        try:
            mesh = make_mesh((1,), ("dict",), device=dev)
            sharded_sparse_code(mesh, sig, d, n_steps=2)   # the communicator's set-up
            sharded, sh_dev, sh_host = once(lambda: sharded_sparse_code(mesh, sig, d, n_steps=S))
        finally:
            dist.destroy_process_group()
    assert_events("sharded_sparse_code vs sparse_code", sharded, naive)
    assert_close("sharded_sparse_code residual", sharded.residual, naive.residual, RESIDUAL_TOL)
    _, nv_dev, nv_host = once(lambda: sparse_code(sig, d, n_steps=S))
    print(f"sparse layer 5, sharded_sparse_code on one {backend} rank, mesh (dict=1), {B} items x "
          f"{N} atoms, {S} steps: {ms_text(sh_dev, sh_host)}; events equal to sparse_code's "
          f"({ms_text(nv_dev, nv_host)})")

    launches = dict(kernels.LAUNCHES)
    want = {k: 0 for k in launches}
    if on_card:
        want.update(cuda_fused_encode=1, cuda_fused_step_pipelined=2 * S)
    if launches != want:
        fail(f"sparse layer: launches {launches}, expected {want}")
    records["cuda_fused_encode"]["launches_sparse_layer"] = launches["cuda_fused_encode"]
    records["cuda_fused_step_pipelined"]["launches_sparse_layer"] = (
        launches["cuda_fused_step_pipelined"])
    print(f"sparse layer launches {launches}; the phase took "
          f"{time.perf_counter() - t_phase:.1f} s (host clock)")

    # part 3's encode outside the counted run: sparse_code_fast as
    # dictionary_learning_step calls it (one chain of S cluster step kernel
    # launches at the learning block) against the naive coder
    before = kernels.LAUNCHES["cuda_fused_step_pipelined"]
    learned = sparse_code_fast(sig, d, n_steps=S, block=learning_block(A), fused=on_card,
                               block_argmax=on_card)
    if kernels.LAUNCHES["cuda_fused_step_pipelined"] - before != (S if on_card else 0):
        fail("the learning path's encode did not run through the cluster step kernel")
    assert_events("the learning path's encode vs sparse_code", learned, naive)
    assert_close("the learning path's encode residual", learned.residual, naive.residual,
                 RESIDUAL_TOL)
    print(f"check the learning path's encode (block {learning_block(A)}, {S} steps, {B} items): "
          f"events equal to sparse_code's, values max abs err "
          f"{max_err([(learned.values, naive.values)]):.3e}, residual max abs err "
          f"{max_err([(learned.residual, naive.residual)]):.3e}")


def splat_groups(model):
    """Parameter names of the splat model by group: the MLP heads, the
    hierarchy's event vectors, its times, the reverb MLPs."""
    groups = {"heads": [], "vectors": [], "times": [], "reverb": []}
    for name, _ in model.named_parameters():
        key = ("heads" if name.startswith("transform.") else
               "reverb" if name.startswith("decoder.") else
               "times" if "time" in name else "vectors")
        groups[key].append(name)
    return groups


def splat_phase(dev, cfg, sync):
    """Phase 6, the splat overfit (BASELINE #3, scripts/splat.py's
    configuration), launch counts set to 0 first and read last: (1) one
    forward and backward at full width on the card against the CPU, the
    same parameters (a state_dict) and noise: events, loss, every gradient
    by group; the times' gradients, float32 noise on either side, also in
    float64; (2) ``overfit_splat`` on the card, warm-up steps then timed
    steps, the loss falling; (3) one step split by CUDA events into
    forward, loss, backward and optimizer, one traced with torch.profiler,
    and its peak memory; (4) steps of the iterative loss; (5) none of the
    six kernels launched."""
    import torch

    from mptpu_torch import kernels
    from mptpu_torch.models import OverfitHierarchicalEvents, overfit_splat
    from mptpu_torch.models.splat_overfit import splat_loss, splat_loss_transform
    from mptpu_torch.train import optimizer

    n, sr, E, C = (cfg[k] for k in ("n_samples", "samplerate", "n_events", "context_dim"))
    on_card = dev.type == "cuda"
    target_np = sines_signal(n, np.random.default_rng(0))
    noise_np = np.random.default_rng(1).uniform(-1, 1, (1, 1, n)).astype(np.float32)
    kernels.reset_launches()
    t_phase = time.perf_counter()

    # 1. the card against the CPU, one forward and backward at full width
    model = OverfitHierarchicalEvents(n, sr, E, C, device=dev)
    state = {k: v.cpu() for k, v in model.state_dict().items()}
    groups = splat_groups(model)

    def forward_backward(device, dtype):
        m = OverfitHierarchicalEvents(n, sr, E, C, device=device)
        m.load_state_dict(state)
        m = m.to(dtype)
        target = torch.from_numpy(target_np).to(device, dtype).reshape(1, 1, n)
        t0 = time.perf_counter()
        recon, _, _ = m(noise=torch.from_numpy(noise_np).to(device, dtype))
        loss = splat_loss(recon, target)
        names, params = zip(*m.named_parameters())
        grads = torch.autograd.grad(loss, params, allow_unused=True, materialize_grads=True)
        sync()
        ms = (time.perf_counter() - t0) * 1e3
        return (recon.detach().cpu().double(), loss.detach().cpu().double(),
                {k: g.detach().cpu().double() for k, g in zip(names, grads)}, ms)

    card = forward_backward(dev, torch.float32)
    cpu = forward_backward(torch.device("cpu"), torch.float32)
    card64 = forward_backward(dev, torch.float64)
    cpu64 = forward_backward(torch.device("cpu"), torch.float64)
    scale = float(cpu[0].abs().max())
    ev_err = max_err([(card[0], cpu[0])])
    loss_rel = abs(float(card[1] - cpu[1])) / abs(float(cpu[1]))
    errs = {}   # group: (max abs err, largest |gradient|)
    for group, names in groups.items():
        errs[group] = (max_err([(card[2][k], cpu[2][k]) for k in names]),
                       max(float(cpu[2][k].abs().max()) for k in names))
    times = groups["times"]
    errs["times, float64"] = (max_err([(card64[2][k], cpu64[2][k]) for k in times]),
                              max(float(cpu64[2][k].abs().max()) for k in times))
    errs["times, card float32 against float64"] = (
        max_err([(card[2][k], card64[2][k]) for k in times]), errs["times, float64"][1])
    print(f"splat 1, one forward and backward at full width ({n} samples, {E} events, context "
          f"{C}; {sum(p.numel() for p in model.parameters())} parameters), card against CPU, "
          f"the same parameters and noise: events max abs err {ev_err:.3e} (largest "
          f"{scale:.3e}), loss {float(card[1]):.6f} against {float(cpu[1]):.6f} (relative "
          f"{loss_rel:.2e}); gradients, max abs err (largest): "
          + ", ".join(f"{g} {e:.3e} ({m:.3e})" for g, (e, m) in errs.items())
          + f"; host ms card {card[3]:.1f}, CPU {cpu[3]:.1f}, card float64 {card64[3]:.1f}, CPU "
          f"float64 {cpu64[3]:.1f}")
    if not (torch.isfinite(card[0]).all() and tuple(card[0].shape) == (1, E, n)):
        fail("splat: the card's events are not finite or not (1, n_events, n_samples)")
    if ev_err > SPLAT_TOL["events"] * scale:
        fail(f"splat: events on the card {ev_err:.3e} from the CPU's, above "
             f"{SPLAT_TOL['events']} of {scale:.3e}")
    if loss_rel > SPLAT_TOL["loss"]:
        fail(f"splat: loss on the card {loss_rel:.2e} from the CPU's (relative)")
    for group, names in groups.items():
        # the times' gradients are float32 noise on either side: held in float64
        pairs = ([(card64[2][k], cpu64[2][k]) for k in names] if group == "times"
                 else [(card[2][k], cpu[2][k]) for k in names])
        rtol = SPLAT_TOL["times64"] if group == "times" else SPLAT_TOL["gradients"]
        for (a, b), k in zip(pairs, names):
            assert_close(f"splat gradient {k}, card against CPU", a, b,
                         dict(rtol=rtol, atol=rtol * max(float(b.abs().max()), 1e-30)))
    del card, cpu, card64, cpu64, model, state

    # 2. the trainer
    gen = torch.Generator(device=dev).manual_seed(0)
    fit = overfit_splat(target_np, n_events=E, event_dim=C, n_iterations=cfg["steps"],
                        lr=cfg["lr"], warmup=cfg["warmup"], samplerate=sr, device=dev,
                        generator=gen)
    losses = fit.losses
    if fit.skipped or not all(np.isfinite(losses)):
        fail(f"splat overfit: {fit.skipped} steps skipped by the guard")
    if not losses[-1] < losses[0]:
        fail(f"splat overfit: the loss did not fall ({losses[0]:.4f} -> {losses[-1]:.4f})")
    step_ms = 1e3 / fit.steps_per_sec
    print(f"splat 2, overfit_splat on the card: {cfg['warmup']} warm-up steps, then "
          f"{cfg['steps']} timed: {fit.steps_per_sec:.3f} steps/s ({step_ms:.3f} ms a step, host "
          f"clock ending in a synchronisation); loss first step {losses[0]:.4f}, last "
          f"{losses[-1]:.4f} (means of the first and last 10: {np.mean(losses[:10]):.4f}, "
          f"{np.mean(losses[-10:]):.4f}); {fit.skipped} steps skipped by the guard")

    # 3. one step split, traced and its peak memory
    model = fit.model
    target = torch.from_numpy(target_np).to(dev).reshape(1, 1, n)
    with torch.no_grad():
        feature = splat_loss_transform(target)
    opt = optimizer(model.parameters(), lr=cfg["lr"], b1=0.9, b2=0.999)

    def one_step(mark=lambda: None):
        opt.zero_grad(set_to_none=True)
        mark()
        recon, _, _ = model(generator=gen)
        mark()
        loss = splat_loss(recon, target, target_feature=feature)
        mark()
        loss.backward()
        mark()
        if bool(torch.isfinite(loss)):
            opt.step()
        mark()

    for _ in range(2):
        one_step()
    parts = "forward, loss, backward, optimizer"
    if on_card:
        events, host = [], []

        def mark():
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()
            host.append(time.perf_counter())

        one_step(mark)
        sync()
        split = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
        split_text = ", ".join(f"{p} {ms:.3f}" for p, ms in zip(parts.split(", "), split))
        host_text = ", ".join(f"{(b - a) * 1e3:.3f}" for a, b in zip(host, host[1:]))
        traced = device_time_by_kernel(one_step, sync)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        one_step()
        sync()
        peak = torch.cuda.max_memory_allocated(dev)
        if peak >= 16 * 2**30:
            fail(f"splat step: peak {peak / 2**30:.2f} GiB, not under 16 GiB")
        print(f"splat 3, one step split by CUDA events ({parts}), ms: {split_text} (host clock "
              f"between the same marks: {host_text}); traced: {traced[2]} kernel launches a step; "
              f"peak memory {peak / 2**30:.3f} GiB over a step (from {base / 2**30:.3f} GiB "
              f"before, limit 16 GiB)")
        print(busy_line("splat step, traced", traced, step_ms))
    else:
        one_step()
        print("splat 3, one step: split, trace and peak memory not measured (no card)")

    # 4. the iterative loss
    it = overfit_splat(target_np, n_events=E, event_dim=C, n_iterations=cfg["iterative_steps"],
                       lr=cfg["lr"], use_iterative_loss=True, samplerate=sr, device=dev,
                       generator=torch.Generator(device=dev).manual_seed(1))
    if it.skipped or not all(np.isfinite(it.losses)):
        fail(f"splat overfit with the iterative loss: non-finite losses {it.losses}")
    print(f"splat 4, overfit_splat(use_iterative_loss=True), {cfg['iterative_steps']} steps: "
          f"{it.steps_per_sec:.3f} steps/s, losses finite, first {it.losses[0]:.4f}, last "
          f"{it.losses[-1]:.4f}")

    # 5. none of the six kernels
    launches = dict(kernels.LAUNCHES)
    if launches != {k: 0 for k in launches}:
        fail(f"splat phase: launches {launches}, expected none")
    print(f"splat launches {launches}; the phase took {time.perf_counter() - t_phase:.1f} s "
          f"(host clock)")


def siam_model(dev, cfg, dtype=None):
    """The SIAM model of ``cfg`` (scripts/codec_rate.py:187-196's flags,
    switch_bias_init as sw6 trained) from seed 0, on ``dev``."""
    import torch

    from mptpu_torch.models import SIAMModel

    model = SIAMModel(
        n_samples=cfg["n_samples"], context_dim=cfg["context_dim"],
        in_channels=cfg["window"] // 2 + 1, hidden_channels=cfg["hidden"],
        n_events=cfg["n_events"], transform_window_size=cfg["window"],
        transform_step_size=cfg["step"], fft_resonance=True, attn_floor=0.01, attn_leak=0.1,
        switch_clamp=20.0, residual_clamp_scale=4.0, encoder_clamp=1e4, switch_bias_init=1.0,
        generator=torch.Generator().manual_seed(0), device=dev)
    return model if dtype is None else model.to(dtype)


def first_window(codec, target, enc_input, max_shift, wire=None):
    """scripts/codec_rate.py's first window through ``codec``: the encode,
    the f16 wire decode, the shift and gain refinement of the wire's
    channels within ``max_shift`` samples against the target's first half
    (the corrections carried as i16 and f16). ``wire``, another run's
    quantized (vecs, schedules), is decoded in place of this encode's own,
    so that two devices' decoders are held on the same wire bits. Returns
    the outputs and the smallest top-1 / top-2 attention gap of the
    encode's steps."""
    import torch

    from mptpu_torch.models import SIAMEncoding, quantize_events, refine_event_alignment

    half = target.shape[-1] // 2
    gaps = []

    def on_switch(module, args, out):
        # the attention over the window's first half, where events may sit
        attn = torch.relu(out[..., 0])[:, : out.shape[1] // 2]
        top = torch.topk(attn, 2, dim=-1).values
        gaps.append(float((top[:, 0] - top[:, 1]).min()))

    hook = codec.model.to_event_switch.register_forward_hook(on_switch)
    try:
        enc = codec.encode(enc_input)
    finally:
        hook.remove()
    vecs_q, sched_q, _ = quantize_events(enc.vecs, enc.schedules, "f16")
    own = (vecs_q, sched_q)
    if wire is not None:
        vecs_q, sched_q = (w.to(codec.device) for w in wire)
    rendered = codec.render(vecs_q, sched_q)
    with torch.no_grad():
        _, shifts, gains = refine_event_alignment(target[..., :half], rendered[..., :half],
                                                  max_shift=max_shift)
    refined = codec.decode(SIAMEncoding(vecs_q, sched_q, rendered, gains.half().float(), shifts))
    out = dict(vecs=enc.vecs, frames=enc.schedules.argmax(-1), channels=enc.channels,
               wire_vecs=own[0], wire_sched=own[1], wire=rendered, shifts=shifts,
               raw=enc.channels.sum(1, keepdim=True), refined=refined)
    return {k: v.detach().cpu() for k, v in out.items()}, min(gaps)


def first_half_snr(target, recon):
    """SNR in dB of ``recon`` against ``target`` over the first half, the
    span the streaming mask lets a window's events cover."""
    import torch

    half = target.shape[-1] // 2
    t, r = target.double()[..., :half], recon.double()[..., :half]
    return float(10 * torch.log10(t.pow(2).sum() / (t - r).pow(2).sum()))


def siam_phase(dev, cfg, sync):
    """Phase 7, the SIAM codec's serving path (BASELINE #4) at full width,
    launch counts set to 0 first and read last: (1) scripts/codec_rate.py's
    first window (encode, f16 wire decode, alignment refinement) on the
    card against the CPU from one state_dict and one noise draw; (2) the
    handoff walk over the whole segment, card against CPU; (3) times of
    encode, decode, refinement and walk, one encode traced, its peak
    memory; (4) the encode's distance from float64 with the end
    coefficients made real before each inverse FFT and without; (5) none
    of the six kernels launched."""
    import torch

    from mptpu_torch import kernels
    from mptpu_torch.data import synthetic_audio
    from mptpu_torch.gen import overfitresonance
    from mptpu_torch.models import (SIAMCodec, SIAMEncoding, fade_tail, quantize_events,
                                    refine_event_alignment, siam, streaming_encode)
    from mptpu_torch.models.siam import draw_noise
    from mptpu_torch.ops import fft as fft_ops
    from mptpu_torch.sparse import quantize

    n, E, max_shift = cfg["n_samples"], cfg["n_events"], cfg["max_shift"]
    on_card = dev.type == "cuda"
    knobs = (quantize.RELU_SELECTION_LEAK, quantize.RELU_SELECTION_FLOOR)
    quantize.set_selection_leak(0.02)    # scripts/codec_rate.py:163-168
    quantize.set_selection_floor(0.02)
    seg = synthetic_audio(cfg["walk_samples"], 22050, n_events=cfg["audio_events"], seed=3,
                          sustained=True).reshape(1, 1, -1)
    kernels.reset_launches()
    t_phase = time.perf_counter()

    # 1. the first window, the card against the CPU
    model = siam_model(dev, cfg)
    state = {k: v.cpu() for k, v in model.state_dict().items()}
    noise = draw_noise(model, (E, 1), torch.Generator(device=dev).manual_seed(0))
    cpu_model = siam_model(torch.device("cpu"), cfg)
    cpu_model.load_state_dict(state)
    codecs = {"card": SIAMCodec(model=model, checkpoint_dir=None, noise=noise),
              "CPU": SIAMCodec(model=cpu_model, checkpoint_dir=None, noise=noise.cpu())}
    target = {k: torch.from_numpy(seg[..., :n].copy()).to(c.device) for k, c in codecs.items()}
    enc_input = {k: target[k] * fade_tail(n, device=c.device) for k, c in codecs.items()}
    runs, host_ms, wire = {}, {}, None
    for k, c in codecs.items():   # the CPU decodes the card's wire bits
        t0 = time.perf_counter()
        runs[k] = first_window(c, target[k], enc_input[k], max_shift, wire)
        host_ms[k] = (time.perf_counter() - t0) * 1e3
        wire = (runs[k][0]["wire_vecs"], runs[k][0]["wire_sched"])
    (card, gap), (cpu, cpu_gap) = runs["card"], runs["CPU"]
    flips = [int((card[m] != cpu[m]).sum()) for m in ("wire_vecs", "wire_sched")]
    tgt = target["CPU"].cpu()
    snrs = {k: {m: first_half_snr(tgt, r[0][m]) for m in ("raw", "refined")}
            for k, r in runs.items()}
    for k, r in runs.items():
        snrs[k]["wire"] = first_half_snr(tgt, r[0]["wire"].sum(1, keepdim=True))
    errs = {m: max_err([(card[m], cpu[m])]) / max(float(cpu[m].abs().max()), 1e-30)
            for m in ("vecs", "channels", "wire", "refined")}
    print(f"siam 1, scripts/codec_rate.py's first window ({n} samples, {E} events, "
          f"hidden {cfg['hidden']}, context {cfg['context_dim']}, STFT {cfg['window']}/"
          f"{cfg['step']}; {sum(p.numel() for p in model.parameters())} parameters from seed 0), "
          f"card against CPU from one state_dict and one noise draw: frames "
          f"{'identical' if torch.equal(card['frames'], cpu['frames']) else 'DIFFERENT'} "
          f"({card['frames'][0].tolist()}), smallest top-1 / top-2 attention gap of the steps "
          f"{gap:.4e} (CPU {cpu_gap:.4e}); shifts "
          f"{'identical' if torch.equal(card['shifts'], cpu['shifts']) else 'DIFFERENT'}; max abs "
          f"err over the largest: " + ", ".join(f"{m} {e:.2e}" for m, e in errs.items())
          + "; first-half SNR dB card / CPU: " + ", ".join(
              f"{m} {snrs['card'][m]:.4f} / {snrs['CPU'][m]:.4f}" for m in ("raw", "wire",
                                                                            "refined"))
          + f"; the two encodes' f16 wire values differ in {flips[0]} of {card['vecs'].numel()} "
          f"vector lanes and {flips[1]} amplitudes (both decodes read the card's); host ms card "
          f"{host_ms['card']:.0f} (first call), CPU {host_ms['CPU']:.0f}")
    for k, (r, _) in runs.items():
        if not all(torch.isfinite(v.double()).all() for v in r.values()):
            fail(f"siam: non-finite outputs on the {k}")
    if tuple(card["channels"].shape) != (1, E, n):
        fail(f"siam: channels {tuple(card['channels'].shape)}, not (1, {E}, {n})")
    if not torch.equal(card["frames"], cpu["frames"]):
        fail("siam: event frames differ between the card and the CPU")
    if not torch.equal(card["shifts"], cpu["shifts"]):
        fail("siam: refinement shifts differ between the card and the CPU")
    assert_close("siam vecs, card against CPU", card["vecs"], cpu["vecs"],
                 dict(rtol=1e-4, atol=1e-6 * float(cpu["vecs"].abs().max())))
    for m in ("channels", "wire", "refined"):
        if errs[m] > SIAM_TOL:
            fail(f"siam {m}: card {errs[m]:.2e} of the largest from the CPU, above {SIAM_TOL}")
    for m in ("raw", "wire", "refined"):
        if abs(snrs["card"][m] - snrs["CPU"][m]) >= 0.01:
            fail(f"siam {m} SNR: card {snrs['card'][m]:.4f} dB, CPU {snrs['CPU'][m]:.4f} dB")

    # 2. the handoff walk over the whole segment, with the fixed noise
    def walk(codec):
        audio = torch.from_numpy(seg).to(codec.device)
        return streaming_encode(codec.model, audio, codec.noise, fixed_noise=True)

    walks = {k: walk(c).cpu() for k, c in codecs.items()}
    walk_err = max_err([(walks["card"], walks["CPU"])]) / float(walks["CPU"].abs().max())
    frames = n // cfg["step"]
    windows = len(range(0, seg.shape[-1] // cfg["step"] - frames, frames // 2))
    print(f"siam 2, the handoff walk over {seg.shape[-1]} samples ({windows} windows), card "
          f"against CPU: max abs err {walk_err:.2e} of the largest")
    if not torch.isfinite(walks["card"]).all() or walk_err > SIAM_TOL:
        fail(f"siam walk: card {walk_err:.2e} of the largest from the CPU, above {SIAM_TOL}")
    del cpu_model, codecs["CPU"]

    # 3. times on the card, its trace and peak memory
    codec, x, tg = codecs["card"], enc_input["card"], target["card"]
    enc = codec.encode(x)
    vecs_q, sched_q, _ = quantize_events(enc.vecs, enc.schedules, "f16")
    wire = SIAMEncoding(vecs_q, sched_q, codec.render(vecs_q, sched_q))

    def refine():
        with torch.no_grad():
            return refine_event_alignment(tg[..., : n // 2], wire.channels[..., : n // 2],
                                          max_shift=max_shift)

    calls = {"encode": lambda: codec.encode(x), "decode": lambda: codec.decode(wire),
             "refine": refine, "walk": lambda: walk(codec)}
    times = {}
    for name, fn in calls.items():
        fn()
        sync()
        t0 = time.perf_counter()
        for _ in range(cfg["reps"]):
            fn()
        sync()
        times[name] = (time.perf_counter() - t0) * 1e3 / cfg["reps"]
    print(f"siam 3, host ms (mean of {cfg['reps']} after a warm-up, ending in a "
          "synchronisation): " + ", ".join(f"{k} {v:.1f}" for k, v in times.items()))
    if on_card:
        traced = device_time_by_kernel(lambda: codec.encode(x), sync)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        codec.encode(x)
        sync()
        peak = torch.cuda.max_memory_allocated(dev)
        print(f"siam 3, one encode traced: {traced[2]} kernel launches ({traced[2] / E:.0f} a "
              f"step); peak memory {peak / 2**30:.3f} GiB (from {base / 2**30:.3f} GiB before)")
        print(busy_line("siam encode, traced", traced, times["encode"]))
        # one step of the 32, by part: each part's launches, busy time, and
        # its time between CUDA events against the host clock
        rows = []
        with torch.no_grad():
            spec = model.transform(x)
            vecs, sched = model.encode(spec)
            ch = model.generate(vecs, sched, noise=noise[0], spec=spec)
            parts = {"encoder and selection": lambda: model.encode(spec),
                     "heads and decoder": lambda: model.generate(vecs, sched, noise=noise[0],
                                                                 spec=spec),
                     "transform and subtract": lambda: spec - model.transform(ch)}
            for name, fn in parts.items():
                _, dev_ms, part_ms = timed(fn, 5, dev, host=True)
                tr = device_time_by_kernel(fn, sync)
                rows.append(f"{name}: {tr[2]} launches, busy {tr[1]:.3f} ms, {dev_ms:.3f} ms "
                            f"between CUDA events, {part_ms:.3f} ms host clock")
        print("siam 3, one step of the encode by part (mean of 5 calls after a warm-up; busy "
              "from one traced call): " + "; ".join(rows))
    else:
        print("siam 3, trace, parts and peak memory not measured (no card)")

    # 4. trap (b): the encode's distance from float64, with and without real ends
    model64 = siam_model(dev, cfg, torch.float64)
    model64.load_state_dict(state)
    codec64 = SIAMCodec(model=model64, checkpoint_dir=None, noise=noise.double())
    ref = codec64.encode(x.double()).channels

    def distance(c):
        ch = c.encode(x).channels
        return float((ch.double() - ref).abs().max() / ref.abs().max())

    with_ends = distance(codec)
    holders = (fft_ops, overfitresonance, siam)
    kept = [m.real_ends for m in holders]
    for m in holders:
        m.real_ends = lambda spec: spec
    try:
        without = distance(codec)
    finally:
        for m, f in zip(holders, kept):
            m.real_ends = f
    print(f"siam 4, the encode's channels in float32 on the {'card' if on_card else 'CPU'} "
          f"against float64 on the same device, max abs err over the largest: {with_ends:.2e} "
          f"with the end coefficients' imaginary parts zeroed before each inverse FFT, "
          f"{without:.2e} without")
    del model64, codec64, ref
    # the inverse alone at the path's two lengths (SpectralResonance and the
    # spectral filter at n, fft_shift at 3 n), on spectra with non-zero ends
    errs = {}
    for length in (n, 3 * n):
        g = torch.Generator().manual_seed(length)
        spec = torch.complex(torch.randn(4, length // 2 + 1, generator=g, dtype=torch.float64),
                             torch.randn(4, length // 2 + 1, generator=g, dtype=torch.float64))
        spec = spec.to(dev)
        ref = torch.fft.irfft(fft_ops.real_ends(spec), n=length)
        for label, ends in (("zeroed", fft_ops.real_ends), ("raw", lambda z: z)):
            out = torch.fft.irfft(ends(spec.to(torch.complex64)), n=length)
            errs[length, label] = float((out.double() - ref).abs().max() / ref.abs().max())
    print("siam 4, the float32 inverse real FFT alone against float64 with the ends zeroed, max "
          "abs err over the largest: " + "; ".join(
              f"{length} samples {errs[length, 'zeroed']:.2e} zeroed, {errs[length, 'raw']:.2e} raw"
              for length in (n, 3 * n)))

    # 5. none of the six kernels
    quantize.set_selection_leak(knobs[0])
    quantize.set_selection_floor(knobs[1])
    launches = dict(kernels.LAUNCHES)
    if launches != {k: 0 for k in launches}:
        fail(f"siam phase: launches {launches}, expected none")
    print(f"siam launches {launches}; the phase took {time.perf_counter() - t_phase:.1f} s "
          f"(host clock)")


def share_err(a, b) -> float:
    """max |a - b| over max |b| in float64 (complex128 for complex tensors,
    their differences as magnitudes), on the host."""
    import torch

    wide = torch.complex128 if b.is_complex() else torch.float64
    a, b = a.detach().cpu().to(wide), b.detach().cpu().to(wide)
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def ssm_phase(dev, cfg, sync):
    """Phase 8, the playable state-space model (BASELINE #5,
    scripts/ssm_article.py's configuration), launch counts set to 0 first
    and read last, the demo corpus written under a temporary MPTPU_CACHE:
    (1) the target from ``get_one_audio_segment(seed=0)``; (2) one forward
    and backward of the overfit at full width on the card against the CPU
    from one state_dict (audio, boundary differences, loss, gradients by
    group), the card's float32 audio against float64 on the card, and
    cuDNN's RNN with TF32 allowed and not against float64;
    (3) ``train_model_for_segment`` on the card, warm-up then timed steps,
    the loss falling, one step traced and its peak memory, ``random`` and
    ``rolled_control_plane``, the weights JSON round trip; (4)
    ``CompressionModel`` at its full width, forward and the gradient of
    sum(|audio|), card against CPU, its ``param_count``; (5) ``SSM`` and
    ``StateSpaceModelEventGenerator`` forward at BASELINE #5's widths, card
    against CPU; (6) none of the six kernels launched."""
    import os
    import tempfile

    import torch

    from mptpu_torch import convert, kernels
    from mptpu_torch.data import get_one_audio_segment
    from mptpu_torch.gen import SSM, CompressionModel, StateSpaceModelEventGenerator, param_count
    from mptpu_torch.models import OverfitControlPlane, generate_param_dict, train_model_for_segment
    from mptpu_torch.models.ssm_overfit import (make_script_step, read_param_dict, ssm_loss,
                                                transform)

    n, window, cpd, state, sites = (cfg[k] for k in ("n_samples", "window", "control", "state",
                                                      "sites"))
    on_card = dev.type == "cuda"
    saved = {k: os.environ.get(k) for k in ("MPTPU_CACHE", "AUDIO_PATH")}
    tmp = tempfile.TemporaryDirectory()
    os.environ["MPTPU_CACHE"] = tmp.name
    os.environ.pop("AUDIO_PATH", None)
    try:
        kernels.reset_launches()
        t_phase = time.perf_counter()

        # 1. the target, from the demo corpus
        t0 = time.perf_counter()
        target = get_one_audio_segment(n, seed=0, device=dev)
        print(f"ssm 1, the target: get_one_audio_segment({n}, seed=0) from the demo corpus "
              f"written under a temporary MPTPU_CACHE, {tuple(target.shape)} on {target.device}, "
              f"peak {float(target.abs().max()):.6f}, {(time.perf_counter() - t0) * 1e3:.0f} ms "
              f"(host clock, the corpus written included)")
        if tuple(target.shape) != (1, 1, n) or not torch.isfinite(target).all():
            fail("ssm: the target is not finite or not (1, 1, n_samples)")

        # 2. the card against the CPU, one forward and backward at full width
        build = lambda device: OverfitControlPlane(cpd, window, state, n, window, sites,
                                                   device=device)
        model = build(dev)
        n_params = sum(p.numel() for p in model.parameters())
        if n_params != cfg["params"]:
            fail(f"ssm overfit: {n_params} parameters, expected {cfg['params']}")
        state_dict = {k: v.cpu() for k, v in model.state_dict().items()}
        groups = SSM_GROUPS

        def forward_backward(device, dtype):
            m = build(device)
            m.load_state_dict(state_dict)
            m = m.to(dtype)
            tgt = target.to(device, dtype)
            t0 = time.perf_counter()
            audio, diff = m()
            residual = transform(audio) - transform(tgt)
            loss = torch.abs(residual).sum() + torch.abs(diff).sum()
            names, params = zip(*m.named_parameters())
            grads = torch.autograd.grad(loss, params)
            sync()
            ms = (time.perf_counter() - t0) * 1e3
            return (audio.detach(), diff.detach(), loss.detach(), dict(zip(names, grads)), ms,
                    torch.sign(residual.detach()).cpu())

        card = forward_backward(dev, torch.float32)
        cpu = forward_backward(torch.device("cpu"), torch.float32)
        card64 = forward_backward(dev, torch.float64)
        cpu64 = forward_backward(torch.device("cpu"), torch.float64)
        errs = {"audio": share_err(card[0], cpu[0]), "boundaries": share_err(card[1], cpu[1])}
        loss_rel = abs(float(card[2]) - float(cpu[2])) / abs(float(cpu[2]))

        def grad_errs(a, b):
            return {g: max(share_err(a[3][k], b[3][k]) for k in names)
                    for g, names in groups.items()}

        pairs = {"card against CPU": grad_errs(card, cpu),
                 "float64 card against CPU": grad_errs(card64, cpu64),
                 "card float32 against float64": grad_errs(card, card64),
                 "CPU float32 against float64": grad_errs(cpu, cpu64)}
        flips = {"float32": int((card[5] != cpu[5]).sum()),
                 "float64": int((card64[5] != cpu64[5]).sum()),
                 "CPU float32 against float64": int((cpu[5] != cpu64[5]).sum())}
        err64 = share_err(card[0], card64[0])
        print(f"ssm 2, one forward and backward at full width ({n} samples, window {window}, "
              f"control {cpd}, state {state}, {sites} sites; {n_params} parameters from seed 0), "
              f"card against CPU from one state_dict, max abs err over the largest: audio "
              f"{errs['audio']:.2e}, boundaries {errs['boundaries']:.2e}; loss "
              f"{float(card[2]):.6f} against {float(cpu[2]):.6f} (relative {loss_rel:.2e}); "
              f"the card's float32 audio against float64 on the card {err64:.2e}; host ms "
              f"card {card[4]:.1f}, CPU {cpu[4]:.1f}, card float64 {card64[4]:.1f}, CPU float64 "
              f"{cpu64[4]:.1f}")
        print("ssm 2, gradients by group, max abs err over the largest: " + "; ".join(
            f"{what}: " + ", ".join(f"{g} {e:.2e}" for g, e in ge.items())
            for what, ge in pairs.items())
            + f"; signs of the loss's l1 residual ({card[5].numel()} entries) that differ: "
            + ", ".join(f"{k} {v}" for k, v in flips.items()))
        if not (torch.isfinite(card[0]).all() and tuple(card[0].shape) == (1, 1, n)):
            fail("ssm: the card's audio is not finite or not (1, 1, n_samples)")
        for what, e in errs.items():
            if e > SSM_TOL["audio"]:
                fail(f"ssm {what}: card {e:.2e} of the largest from the CPU, above "
                     f"{SSM_TOL['audio']}")
        if loss_rel > SSM_TOL["loss"]:
            fail(f"ssm: loss on the card {loss_rel:.2e} from the CPU's (relative)")
        # in float32 the gradients of this l1 loss of spectral magnitudes are noise at
        # 1e-4 of their largest on either device (a residual's sign flips where it
        # is near 0), so the card is held against the CPU in float64
        for g, e in pairs["float64 card against CPU"].items():
            if e > SSM_TOL["gradients64"]:
                fail(f"ssm gradients {g}, float64: card {e:.2e} of the largest from the CPU, "
                     f"above {SSM_TOL['gradients64']}")
        del card, cpu, card64, cpu64

        # cuDNN's RNN with TF32 allowed and not, each against float64
        with torch.no_grad():
            proj = model.control_signal(model.control).transpose(1, 2) @ model.ssm.proj
            rnn64 = torch.nn.RNN(window, state, nonlinearity="tanh", bias=False,
                                 batch_first=True).to(dev, torch.float64)
            rnn64.load_state_dict(model.ssm.rnn.state_dict())
            ref = rnn64(proj.double())[0]
            kept = torch.backends.cudnn.allow_tf32
            tf32 = {}
            try:
                for flag in (True, False):
                    torch.backends.cudnn.allow_tf32 = flag
                    tf32[flag] = share_err(model.ssm.rnn(proj)[0], ref)
            finally:
                torch.backends.cudnn.allow_tf32 = kept
        print(f"ssm 2, the RNN's states ({'cuDNN' if on_card else 'the CPU'}) against float64, "
              f"max abs err over the largest: {tf32[True]:.2e} with "
              f"torch.backends.cudnn.allow_tf32 True, {tf32[False]:.2e} with it False "
              f"({'follows the flag' if tf32[True] > 10 * tf32[False] else 'the same either way'})")
        if tf32[False] > SSM_TOL["audio"]:
            fail(f"ssm: the RNN without TF32 {tf32[False]:.2e} of the largest from float64")
        del model

        # 3. the overfit on the card
        fit = train_model_for_segment(n_samples=n, window_size=window, control_plane_dim=cpd,
                                      state_dim=state, n_active_sites=sites,
                                      n_iterations=cfg["steps"], lr=cfg["lr"],
                                      warmup=cfg["warmup"], seed=0, device=dev)
        losses = fit.losses
        if fit.skipped or not all(np.isfinite(losses)):
            fail(f"ssm overfit: {fit.skipped} steps with a non-finite loss")
        if not losses[-1] < losses[0]:
            fail(f"ssm overfit: the loss did not fall ({losses[0]:.4f} -> {losses[-1]:.4f})")
        if not torch.equal(fit.target, target):
            fail("ssm overfit: the trainer's target is not get_one_audio_segment(seed=0)'s")
        step_ms = 1e3 / fit.steps_per_sec
        print(f"ssm 3, train_model_for_segment on the card: {cfg['warmup']} warm-up steps, "
              f"then {cfg['steps']} timed: {fit.steps_per_sec:.3f} steps/s ({step_ms:.3f} ms a "
              f"step, host clock ending in a synchronisation); loss first step {losses[0]:.4f}, "
              f"last {losses[-1]:.4f} (means of the first and last 10: "
              f"{np.mean(losses[:10]):.4f}, {np.mean(losses[-10:]):.4f}); "
              f"{fit.skipped} steps with a non-finite loss")
        model = fit.model
        with torch.no_grad():
            t_spec = transform(target)
        opt = torch.optim.Adam(model.parameters(), lr=cfg["lr"], betas=(0.9, 0.999), eps=1e-8)
        step = make_script_step(lambda: ssm_loss(model, t_spec), opt)
        step()
        if on_card:
            traced = device_time_by_kernel(step, sync)
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
            step()
            sync()
            peak = torch.cuda.max_memory_allocated(dev)
            print(f"ssm 3, one step traced: {traced[2]} kernel launches; peak memory "
                  f"{peak / 2**30:.3f} GiB over a step (from {base / 2**30:.3f} GiB before)")
            print(busy_line("ssm step, traced", traced, step_ms))
        else:
            print("ssm 3, one step: trace and peak memory not measured (no card)")
        with torch.no_grad():
            played = {"random": model.random(0.001, torch.Generator(device=dev).manual_seed(7)),
                      "rolled": model.rolled_control_plane(
                          generator=torch.Generator(device=dev).manual_seed(8))}
        for what, audio in played.items():
            peak_abs = float(audio.abs().max())
            if not (torch.isfinite(audio).all() and tuple(audio.shape) == (1, 1, n)
                    and 0.99 < peak_abs <= 1.0):
                fail(f"ssm {what}: not finite, not (1, 1, n_samples) or not max-normed "
                     f"(peak {peak_abs})")
        weights = json.loads(json.dumps(generate_param_dict(model)))
        back = convert.ssm_from_flax(build(dev), read_param_dict(weights))
        same = all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                     back.state_dict().values()))
        if not same:
            fail("ssm: the weights JSON does not give back the parameters")
        print(f"ssm 3, random (p 0.001, seed 7) and rolled (seed 8) control planes: finite, "
              f"max-normed (peaks {', '.join(f'{float(a.abs().max()):.6f}' for a in played.values())}"
              f"); the weights JSON ({len(weights)} leaves, "
              f"{sum(len(v['data']) for v in weights.values())} base64 bytes) round-trips")
        del fit, model, opt, back

        # 4. CompressionModel at its full width
        cc = cfg["compression"]
        cm = CompressionModel(cc["control"], cc["window"], cc["state"], cc["n_samples"],
                              device=dev)
        count = param_count(cm)
        if count != cc["params"]:
            fail(f"CompressionModel: param_count {count}, expected {cc['params']}")
        cm_state = {k: v.cpu() for k, v in cm.state_dict().items()}

        def compression(device):
            m = CompressionModel(cc["control"], cc["window"], cc["state"], cc["n_samples"],
                                 device=device)
            m.load_state_dict(cm_state)
            t0 = time.perf_counter()
            audio = m()
            names, params = zip(*m.named_parameters())
            grads = torch.autograd.grad(audio.abs().sum(), params)
            sync()
            return audio.detach(), dict(zip(names, grads)), (time.perf_counter() - t0) * 1e3

        c_card, c_cpu = compression(dev), compression(torch.device("cpu"))
        c_audio = share_err(c_card[0], c_cpu[0])
        c_grads = {k: share_err(c_card[1][k], c_cpu[1][k]) for k in c_cpu[1]}
        c_flips = int((torch.sign(c_card[0]).cpu() != torch.sign(c_cpu[0])).sum())
        print(f"ssm 4, CompressionModel at full width ({cc['n_samples']} samples, window "
              f"{cc['window']}, control {cc['control']}, state {cc['state']}, complex; "
              f"param_count {count}), card against CPU from one state_dict, max abs err over the "
              f"largest: audio {c_audio:.2e}; gradients of sum(|audio|): "
              + ", ".join(f"{k} {e:.2e}" for k, e in c_grads.items())
              + f"; signs of the audio that differ {c_flips} of {c_cpu[0].numel()}; host ms "
              f"forward and backward card {c_card[2]:.1f}, CPU {c_cpu[2]:.1f}")
        if not (torch.isfinite(c_card[0]).all() and tuple(c_card[0].shape) == (1, 1, cc["n_samples"])):
            fail("CompressionModel: the card's audio is not finite or not (1, 1, n_samples)")
        if c_audio > SSM_TOL["audio"]:
            fail(f"CompressionModel audio: card {c_audio:.2e} of the largest from the CPU")
        for k, e in c_grads.items():
            if e > SSM_TOL["gradients"]:
                fail(f"CompressionModel gradient {k}: card {e:.2e} of the largest from the CPU")
        del cm, c_card, c_cpu

        # 5. SSM and the SSM event generator, forward, at BASELINE #5's widths
        gc = cfg["generator"]
        frames, events = gc["frames"], gc["events"]
        rng = np.random.default_rng(11)
        control = np.maximum(rng.standard_normal((1, cpd, frames)), 0).astype(np.float32)
        ssm = SSM(cpd, window, state, device=dev)
        ssm_state = {k: v.cpu() for k, v in ssm.state_dict().items()}
        gen_kw = dict(context_dim=gc["hyper"], control_plane_dim=cpd, input_dim=window,
                      state_dim=state, hypernetwork_dim=gc["hyper"],
                      hypernetwork_latent=gc["latent"], n_samples=frames * (window // 2),
                      samplerate=22050, n_frames=frames)
        eg = StateSpaceModelEventGenerator(**gen_kw, device=dev)
        eg_state = {k: v.cpu() for k, v in eg.state_dict().items()}
        heads = {k: (0.1 * rng.standard_normal((1, events) + s)).astype(np.float32)
                 for k, s in eg.shape_spec.items()}
        def forward(device):
            s = SSM(cpd, window, state, device=device)
            s.load_state_dict(ssm_state)
            g = StateSpaceModelEventGenerator(**gen_kw, device=device)
            g.load_state_dict(eg_state)
            with torch.no_grad():
                t0 = time.perf_counter()
                a = s(torch.from_numpy(control).to(device))
                sync()
                t1 = time.perf_counter()
                b = g({k: torch.from_numpy(v).to(device) for k, v in heads.items()})
                sync()
            return a, b, (t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3

        card, cpu = forward(dev), forward(torch.device("cpu"))
        s_err, g_err = share_err(card[0], cpu[0]), share_err(card[1], cpu[1])
        print(f"ssm 5, forward at BASELINE #5's widths (control {cpd}, window {window}, state "
              f"{state}, {frames} frames): SSM {tuple(card[0].shape)} card against CPU "
              f"{s_err:.2e} of the largest; StateSpaceModelEventGenerator ({events} events, "
              f"hypernetwork {gc['hyper']} x latent {gc['latent']}) {tuple(card[1].shape)} "
              f"{g_err:.2e}; host ms card {card[2]:.1f} and {card[3]:.1f}, CPU {cpu[2]:.1f} and "
              f"{cpu[3]:.1f}")
        for what, out, e in (("SSM", card[0], s_err), ("the SSM event generator", card[1], g_err)):
            if not torch.isfinite(out).all() or e > SSM_TOL["audio"]:
                fail(f"{what}: not finite, or the card {e:.2e} of the largest from the CPU")
        del card, cpu, ssm, eg

        # 6. none of the six kernels
        launches = dict(kernels.LAUNCHES)
        if launches != {k: 0 for k in launches}:
            fail(f"ssm phase: launches {launches}, expected none")
        print(f"ssm launches {launches}; the phase took {time.perf_counter() - t_phase:.1f} s "
              f"(host clock)")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        tmp.cleanup()


def siam_train_groups(model):
    """The SIAM model's parameter names by group: the encoder, the event
    heads (vectors and switch), the multi-head transform, the decoder."""
    groups = {"encoder": [], "heads": [], "multihead": [], "decoder": []}
    for name, _ in model.named_parameters():
        top = name.split(".")[0]
        key = {"encoder": "encoder", "multihead": "multihead", "resonance": "decoder"}.get(
            top, "heads")
        groups[key].append(name)
    return groups


def siam_train_one_step(device, dtype, state, seg, noise, tiny, sync):
    """One forward and backward of ``SIAMOverfitStep.grads`` under sw6's
    flags, on ``device`` in ``dtype``, from ``state`` (a ``state_dict``) on
    the window ``seg`` (1, 1, n) with ``noise`` (events, 1, 1, size), at
    full width or ``tiny``: (channels, frames, refinement shifts, loss,
    {name: gradient}, host ms)."""
    import torch

    from mptpu_torch.models import siam as siam_mod
    from mptpu_torch.models.siam_overfit import SW6, LossSettings, SIAMOverfitStep, siam_sizes

    sz = siam_sizes(tiny)
    n, window, step_sz = sz["n_samples"], sz["window"], sz["step"]
    half = n // 2
    m = siam_mod.SIAMModel(
        n_samples=n, context_dim=sz["context_dim"], in_channels=window // 2 + 1,
        hidden_channels=sz["hidden"], n_events=noise.shape[0], transform_window_size=window,
        transform_step_size=step_sz, attn_floor=SW6["attn_floor"], attn_leak=SW6["attn_leak"],
        switch_bias_init=SW6["switch_bias_init"], switch_clamp=20.0, residual_clamp_scale=4.0,
        encoder_clamp=1e4, vec_clamp=SW6["vec_clamp"], device=device)
    m.load_state_dict(state)
    m = m.to(dtype)
    tg = torch.from_numpy(seg).to(device, dtype)
    fi = tg * siam_mod.fade_tail(n, device=device).to(dtype)
    nz = noise.to(device, dtype)
    tr = SIAMOverfitStep(m, LossSettings(window, step_sz, SW6["gain_refit"], SW6["gain_reg"]))
    t0 = time.perf_counter()
    with torch.no_grad():
        channels, _, scheds, _ = siam_mod.make_iterative_fn(m)(fi, nz)
        _, shifts, _ = siam_mod.refine_event_alignment(
            tg, channels, max_shift=SW6["align_refine"], n_iters=2, ridge=SW6["gain_refit"],
            span=half)
    loss, _, grads = tr.grads(nz, torch.tensor(SW6["waveform_weight"], device=device,
                                               dtype=dtype), fi, tg, torch.sum(tg[..., :half] ** 2))
    sync()
    ms = (time.perf_counter() - t0) * 1e3
    names = [nm for nm, _ in m.named_parameters()]
    return (channels, scheds.argmax(-1).cpu(), shifts.cpu(), float(loss), dict(zip(names, grads)),
            ms)


def siam_train_phase(dev, cfg, sync):
    """Phase 9, SIAM training (BASELINE #4) at sw6's flags, launch counts
    set to 0 first and read last: (a) ``overfit_siam`` for a few steps
    with evals and one walk eval (ms a step, one step traced, peak memory,
    the loss falling, every step finite); (b) one step's forward and
    backward on the card against the CPU from one state_dict, with TF32
    switched on for the process (frames, refinement shifts, loss,
    channels; gradients by group in float64 and in float32);
    (c) one injected non-finite step: parameters, Adam's state and the EMA
    bit-identical, no device-to-host copy inside the step (traced); (d)
    ``train_and_monitor`` at batch 2 on the demo corpus through
    ``make_data_parallel_step`` on a process group of one rank, and one
    reservoir preview; none of the six kernels launched."""
    import os
    import tempfile
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    from mptpu_torch import kernels
    from mptpu_torch.models import siam as siam_mod
    from mptpu_torch.models.siam_overfit import SW6, overfit_siam, siam_sizes
    from mptpu_torch.models.siam_train import train_and_monitor
    from mptpu_torch.data import synthetic_audio
    from mptpu_torch.nn.init import uniform
    from mptpu_torch.sparse import quantize

    on_card = dev.type == "cuda"
    sz = siam_sizes(cfg["tiny"])
    n, E, window, step_sz = sz["n_samples"], sz["n_events"], sz["window"], sz["step"]
    half = n // 2
    saved = {k: os.environ.get(k) for k in ("MPTPU_CACHE", "AUDIO_PATH")}
    tmp = tempfile.TemporaryDirectory()
    os.environ["MPTPU_CACHE"] = tmp.name
    os.environ.pop("AUDIO_PATH", None)
    knobs = (quantize.RELU_SELECTION_LEAK, quantize.RELU_SELECTION_FLOOR)
    try:
        kernels.reset_launches()
        t_phase = time.perf_counter()

        # (a) the overfit trainer under sw6's flags
        noise = uniform((E, 1, 1, min(8192, n)), -1.0, 1.0,
                        torch.Generator(device=dev).manual_seed(0))
        # one window of the script's target, for the single steps below
        seg = synthetic_audio(n, 22050, n_events=SW6["audio_events"], seed=SW6["seed"],
                              sustained=True).reshape(1, 1, n)
        tgt = torch.from_numpy(seg).to(dev)
        f_in = tgt * siam_mod.fade_tail(n, device=dev)
        tge = torch.sum(tgt[..., :half] ** 2)
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev) if on_card else 0
        lines = []
        t0 = time.perf_counter()
        res = overfit_siam(**dict(SW6, tiny=cfg["tiny"], iterations=cfg["steps"],
                                  eval_every=cfg["eval_every"],
                                  walk_eval_every=cfg["walk_eval_every"]),
                           out=os.path.join(tmp.name, "overfit"), noise=noise, device=dev,
                           log=lines.append)
        sync()
        run_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
        starts = res.iter_starts
        busy_iters = {i for i in range(len(starts)) if i and (
            i % cfg["eval_every"] == 0 or i % 50 == 0 or i % cfg["walk_eval_every"] == 0)}
        plain = [starts[i + 1] - starts[i] for i in range(2, len(starts) - 1)
                 if i not in busy_iters]
        step_ms = 1e3 * float(np.mean(plain))
        losses = [s[1] for s in res.steps]
        logged = res.metrics["losses"]
        model = res.trainer.model
        n_params = sum(p.numel() for p in model.parameters())
        print(f"siam train (a), overfit_siam under sw6's flags ({n} samples, {E} events, hidden "
              f"{sz['hidden']}, context {sz['context_dim']}, STFT {window}/{step_sz}, "
              f"{SW6['stream_windows']} windows; {n_params} parameters from seed 0, the fixed noise "
              f"from a generator seeded 0): {cfg['steps']} steps in {run_s:.1f} s with evals at "
              + ", ".join(str(e["step"]) for e in res.metrics["eval"])
              + f" and a walk eval at {', '.join(str(w['step']) for w in res.metrics.get('walk', []))}"
              f"; {step_ms:.1f} ms a step (host clock, mean of {len(plain)} steps without an "
              f"eval after 2); loss every 25 steps {logged}, every step (read a step late) "
              + ", ".join(f"{v:.2f}" for v in losses))
        for e in res.metrics["eval"]:
            print("siam train (a), eval " + json.dumps(e))
        for w in res.metrics.get("walk", []):
            print("siam train (a), walk " + json.dumps(w))
        if not all(s[4] for s in res.steps) or not all(np.isfinite(losses)):
            fail("siam train: a non-finite step in the overfit")
        third = max(1, len(losses) // 3)
        if not np.mean(losses[-third:]) < np.mean(losses[:third]):
            fail(f"siam train: the loss did not fall (means of the first and last {third} "
                 f"steps {np.mean(losses[:third]):.2f}, {np.mean(losses[-third:]):.2f})")
        if on_card:
            wave_w = torch.tensor(SW6["waveform_weight"], device=dev)
            trainer = res.trainer
            quantize.set_selection_leak(SW6["selection_leak"])
            quantize.set_selection_floor(SW6["selection_floor"])
            traced = device_time_by_kernel(
                lambda: trainer.step(noise, wave_w, 1e3, 1.0, f_in, tgt, tge), sync)
            print(f"siam train (a), one step traced: {traced[2]} kernel launches; peak memory over "
                  f"the run {peak / 2**30:.3f} GiB (from {base / 2**30:.3f} GiB before)")
            print(busy_line("siam train step, traced", traced, step_ms))
        else:
            print("siam train (a), trace and peak memory not measured (no card)")

        # (b) one step, the card against the CPU, TF32 switched on for the process
        kept_tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
        ev = cfg["cpu_events"]
        groups = siam_train_groups(model)

        quantize.set_selection_leak(SW6["selection_leak"])
        quantize.set_selection_floor(SW6["selection_floor"])
        try:
            card, cpu, card64, cpu64 = (
                siam_train_one_step(d, dtype, state, seg, noise[:ev], cfg["tiny"], sync)
                for d, dtype in ((dev, torch.float32), (torch.device("cpu"), torch.float32),
                                 (dev, torch.float64), (torch.device("cpu"), torch.float64)))
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = kept_tf32

        def grad_errs(a, b):
            return {g: max(share_err(a[4][k], b[4][k]) for k in names)
                    for g, names in groups.items()}

        ch_err = share_err(card[0], cpu[0])
        loss_rel = abs(card[3] - cpu[3]) / abs(cpu[3])
        pairs = {"float64 card against CPU": grad_errs(card64, cpu64),
                 "float32 card against CPU": grad_errs(card, cpu),
                 "card float32 against float64": grad_errs(card, card64),
                 "CPU float32 against float64": grad_errs(cpu, cpu64)}
        same = {what: torch.equal(a, b) for what, a, b in (
            ("frames", card[1], cpu[1]), ("shifts", card[2], cpu[2]),
            ("frames64", card64[1], cpu64[1]), ("frames32/64", card[1], card64[1]))}
        print(f"siam train (b), one forward and backward at full width with {ev} of {E} events, "
              f"card against CPU from one state_dict, TF32 allowed for the process: frames "
              f"{'identical' if same['frames'] else 'DIFFERENT'}, refinement shifts "
              f"{'identical' if same['shifts'] else 'DIFFERENT'} (float64 frames "
              f"{'identical' if same['frames64'] else 'DIFFERENT'}; the card's float32 frames "
              f"{'equal' if same['frames32/64'] else 'unequal'} to float64's); loss {card[3]:.6f} "
              f"against {cpu[3]:.6f} (relative {loss_rel:.2e}); channels {ch_err:.2e} of the "
              f"largest; host ms card {card[5]:.0f}, CPU {cpu[5]:.0f}, card float64 "
              f"{card64[5]:.0f}, CPU float64 {cpu64[5]:.0f}")
        print("siam train (b), gradients by group, max abs err over the largest: " + "; ".join(
            f"{what}: " + ", ".join(f"{g} {e:.2e}" for g, e in ge.items())
            for what, ge in pairs.items()))
        if not (same["frames"] and same["shifts"] and same["frames64"]):
            fail("siam train: frames or refinement shifts differ between the card and the CPU")
        if loss_rel > SIAM_TRAIN_TOL["loss"] or ch_err > SIAM_TRAIN_TOL["channels"]:
            fail(f"siam train: loss {loss_rel:.2e} or channels {ch_err:.2e} from the CPU's")
        for bits in (64, 32):
            tol = SIAM_TRAIN_TOL[f"gradients{bits}"]
            for g, e in pairs[f"float{bits} card against CPU"].items():
                if e > tol:
                    fail(f"siam train gradients {g}, float{bits}: card {e:.2e} of the largest "
                         f"from the CPU, above {tol}")
        del card, cpu, card64, cpu64

        # (c) one injected non-finite step
        trainer = res.trainer
        before = ([p.detach().clone() for p in trainer.params], trainer.opt_state,
                  [e.clone() for e in trainer.ema])
        nan_w = torch.tensor(float("nan"), device=dev)
        outs = []
        counts = device_time_by_kernel(lambda: outs.append(trainer.step(
            noise, nan_w, 1e3, 1.0, f_in, tgt, tge)), sync)[3]
        loss, _, gnorm, ok, tail = outs[0]
        copies = {k: v for k, v in counts.items() if k.startswith("Memcpy")}
        reads = {k: v for k, v in copies.items() if "DtoH" in k}
        st, old = trainer.opt_state, before[1]
        kept = (all(torch.equal(a, b) for a, b in zip(trainer.params, before[0]))
                and all(torch.equal(a, b) for a, b in zip(trainer.ema, before[2]))
                and torch.equal(st.count, old.count)
                and all(torch.equal(a, b) for a, b in zip(st.mu + st.nu, old.mu + old.nu)))
        print(f"siam train (c), one step with a NaN waveform weight: ok {bool(ok)}, loss "
              f"{float(loss)}, gnorm {float(gnorm)}; parameters, Adam's moments and count "
              f"({int(st.count)}) and the EMA {'bit-identical' if kept else 'CHANGED'}, the raw "
              f"tail {'zero' if not tail.any() else 'NOT zero'}; the step's device copies, "
              f"traced: " + (", ".join(f"{k} {v}" for k, v in sorted(copies.items()))
                             if on_card else "not measured (no card)")
              + (f" (no read of the device on the host)" if on_card and not reads else ""))
        if on_card and (reads or not copies):
            fail(f"siam train: the step read the device on the host ({reads}) or its trace "
                 f"holds no copy")
        if bool(ok) or not kept or bool(tail.any()):
            fail("siam train: the gate let a non-finite step through")

        # (d) train_and_monitor through the data-parallel step on one rank
        backend = "nccl" if on_card else "gloo"
        dist.init_process_group(backend, store=dist.FileStore(f"{tmp.name}/store", 1), rank=0,
                                world_size=1, timeout=timedelta(seconds=120))
        try:
            out = train_and_monitor(batch_size=cfg["batch"], tiny=cfg["tiny"], port=0,
                                    iterations=cfg["dp_steps"], data_parallel=True, seed=0,
                                    log_every=1, device=dev,
                                    dashboard=os.path.join(tmp.name, "dashboard"),
                                    checkpoint_dir=os.path.join(tmp.name, "siam"),
                                    log=lambda line: None)
        finally:
            dist.destroy_process_group()
        st = out.step_starts
        dp_ms = 1e3 * float(np.mean(np.diff(st[1:]))) if len(st) > 2 else float("nan")
        rvecs = torch.from_numpy(out.reservoir.sample(1, E)).to(dev)
        preview, _, times = siam_mod.make_random_sequence_fn(out.model)(
            rvecs, generator=torch.Generator(device=dev).manual_seed(3))
        mix = preview.sum(1)
        print(f"siam train (d), train_and_monitor at batch {cfg['batch']} on the demo corpus "
              f"(a temporary MPTPU_CACHE), port 0, through make_data_parallel_step on one "
              f"{backend} rank: losses " + ", ".join(f"{v:.3f}" for v in out.losses)
              + f"; {dp_ms:.1f} ms a step (host clock, the mean after the first, a loss read "
              f"every step); the reservoir's preview: {int((times > 0).sum())} of {E} events "
              f"placed, {tuple(mix.shape)}, peak {float(mix.abs().max()):.4e}, "
              f"{'finite' if torch.isfinite(mix).all() else 'NOT finite'}")
        if not all(np.isfinite(out.losses)) or not torch.isfinite(mix).all():
            fail("siam train: train_and_monitor's losses or preview not finite")
        if out.collection.names() != sorted(["loss", "orig", "recon"]):
            fail(f"siam train: the dashboard logged {out.collection.names()}")

        launches = dict(kernels.LAUNCHES)
        if launches != {k: 0 for k in launches}:
            fail(f"siam train phase: launches {launches}, expected none")
        print(f"siam train launches {launches}; the phase took "
              f"{time.perf_counter() - t_phase:.1f} s (host clock)")
    finally:
        quantize.set_selection_leak(knobs[0])
        quantize.set_selection_floor(knobs[1])
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        tmp.cleanup()


def songsplat_fixed_loss(model, song) -> float:
    """The song splat's loss summed over the whole-song render's tiled
    segments, with one fixed noise, on the model's device: the trainer draws
    another segment and noise at every step, so its steps' own losses trend
    only over many steps (python3 tests/reference/songsplat_trajectory.py)."""
    import torch

    from mptpu_torch.models import songsplat as ss
    from mptpu_torch.nn.init import uniform

    dev = model.times.device
    nz = uniform(model.noise_shape, -1.0, 1.0, torch.Generator().manual_seed(2)).to(dev)
    f, n = model.segment_frames, model.n_segment_samples
    with torch.no_grad():
        return sum(float(ss.songsplat_loss(model, torch.from_numpy(
            song[t * model.step_size: t * model.step_size + n].reshape(1, 1, -1)).to(dev), t,
            nz)[0]) for t in range(f, model.total_frames - f, f))


def models_phase(dev, cfg, sync, records=None):
    """Phase 10, the models on ported layers (ROADMAP A10), launch counts
    set to 0 first and read last, the demo corpus under a temporary
    MPTPU_CACHE: (a) the whole-song splat trainer at the reference
    configuration (one step on the card against the CPU at a dense window,
    ``train_songsplat`` for warm-up and timed steps, one step traced, the
    whole-song render with and without the gain refit); (b) the
    instrument at sw6's shapes (a random phrase, a bank harvested from a
    window and a phrase of it; the card against the CPU); (c)
    ``index_corpus`` at build_index.py's defaults (the cluster step
    kernel's launches, by band; a query finds its own chunk; the card
    against the CPU on a few chunks); (d) the learned-atom MP (Adam steps,
    the card against the CPU); (e) no kernel but the cluster step kernel,
    and that one only in (c). ``records``, when given, takes (c)'s count of
    the cluster step kernel."""
    import os
    import tempfile

    import torch
    import torch.nn.functional as F

    from mptpu_torch import kernels
    from mptpu_torch.data import iter_audio_segments, synthetic_audio
    from mptpu_torch.losses import iterative_loss
    from mptpu_torch.models import (BruteForceSearch, MatchingPursuit, build_instrument,
                                    demo_phrase, index_corpus, make_embedder)
    from mptpu_torch.models import songsplat as ss
    from mptpu_torch.models.siam import draw_noise
    from mptpu_torch.nn.init import uniform
    from mptpu_torch.ops import stft, unit_norm
    from mptpu_torch.ops.decompose import fft_frequency_decompose
    from mptpu_torch.sparse import dictionary_gram, encode_state, fast_geometry
    from mptpu_torch.sparse.cuda_fused_mp import fused_step_applicable
    from mptpu_torch.train.optim import Adam
    from mptpu_torch.utils.wav import write_wav

    on_card = dev.type == "cuda"
    cpu = torch.device("cpu")
    K4 = "cuda_fused_step_pipelined"
    saved = {k: os.environ.get(k) for k in ("MPTPU_CACHE", "AUDIO_PATH")}
    tmp = tempfile.TemporaryDirectory()
    os.environ["MPTPU_CACHE"] = tmp.name
    os.environ.pop("AUDIO_PATH", None)

    def peak_reset():
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)

    def peak_gib():
        return torch.cuda.max_memory_allocated(dev) / 2**30 if on_card else float("nan")

    try:
        kernels.reset_launches()
        t_phase = time.perf_counter()

        # (a) the whole-song splat trainer
        c = cfg["songsplat"]
        total, seg_n, eps, cap = ss.TINY if c["tiny"] else ss.REFERENCE
        song = ss.get_song(None, total, 22050)

        def build_splat(device):
            return ss.SongSplatModel(total, seg_n, events_per_second=eps, events_per_segment=cap,
                                     device=device)

        model = build_splat(cpu)
        lo, hi = model.start_range()
        sf = (lo + hi) // 2
        rng = np.random.default_rng(0)
        dense = torch.from_numpy(rng.choice(model.total_events, c["dense"], replace=False))
        frames = torch.from_numpy(rng.integers(sf - model.segment_frames,
                                               sf + model.segment_frames, c["dense"]))
        with torch.no_grad():   # plant more events in the window than the capacity
            model.times[dense, frames] += 1.0
        state = model.state_dict()
        noise = uniform(model.noise_shape, -1.0, 1.0, torch.Generator().manual_seed(0))
        target = torch.from_numpy(song[sf * 256: sf * 256 + seg_n].reshape(1, 1, -1))
        names = [name for name, _ in model.named_parameters()]
        groups = {"events": ["events"], "times": ["times"],
                  "heads": [name for name in names if name.startswith("transform.")],
                  "reverb": [name for name in names if name.startswith("decoder.")]}

        def splat_once(device, dtype):
            m = build_splat(device)
            m.load_state_dict(state)
            m.to(dtype)
            t0 = time.perf_counter()
            idx, _, _ = m.range_query(sf)
            loss, _, count = ss.songsplat_loss(m, target.to(device, dtype), sf,
                                               noise.to(device, dtype))
            names, params = zip(*m.named_parameters())
            grads = torch.autograd.grad(loss, params, allow_unused=True, materialize_grads=True)
            loss = float(loss.detach())
            return idx.cpu(), loss, dict(zip(names, grads)), int(count), \
                (time.perf_counter() - t0) * 1e3

        runs = {(d.type, dt): splat_once(d, dt) for d in (dev, cpu)
                for dt in (torch.float32, torch.float64)}
        card, host = runs[(dev.type, torch.float32)], runs[("cpu", torch.float32)]
        card64, host64 = runs[(dev.type, torch.float64)], runs[("cpu", torch.float64)]

        def group_errs(a, b):
            return {g: max(share_err(a[2][n], b[2][n]) for n in group)
                    for g, group in groups.items()}

        e32, e64 = group_errs(card, host), group_errs(card64, host64)
        same_idx = all(torch.equal(r[0], host[0]) for r in runs.values())
        loss_rel = abs(card[1] - host[1]) / abs(host[1])
        print(f"models (a) song splat, one forward and backward at {total} samples, segments of "
              f"{seg_n} ({model.total_events} events, {model.total_frames} frames, capacity "
              f"{cap}) at start frame {sf} with {c['dense']} events planted in range: "
              f"{card[3]} in range, the range query's indices "
              f"{'identical' if same_idx else 'DIFFERENT'} on both devices in float32 and "
              f"float64; loss {card[1]:.6f} against {host[1]:.6f} (relative {loss_rel:.2e}); "
              f"gradients by group, card against CPU, max abs err over the largest: float64 "
              + ", ".join(f"{g} {e:.2e}" for g, e in e64.items()) + "; float32 "
              + ", ".join(f"{g} {e:.2e}" for g, e in e32.items())
              + f"; host ms card {card[4]:.0f}, CPU {host[4]:.0f}")
        if not same_idx or card[3] <= cap:
            fail(f"models: the range query's indices differ, or {card[3]} events in range do "
                 f"not exceed the capacity {cap}")
        if loss_rel > MODELS_TOL["loss"]:
            fail(f"models: the song splat's loss {loss_rel:.2e} from the CPU's")
        for g, e in e64.items():
            if e > MODELS_TOL["gradients64"]:
                fail(f"models: song splat gradients {g}, float64: {e:.2e} of the largest")
        for g in ("events", "heads"):
            if e32[g] > MODELS_TOL["gradients32"]:
                fail(f"models: song splat gradients {g}, float32: {e32[g]:.2e} of the largest")
        del runs, card, host, card64, host64, model

        initial = build_splat(dev)   # the trainer's initial model, seed 0
        before = songsplat_fixed_loss(initial, song)
        _, eval_before = ss.render_song(initial, song, 0.0, device=dev)
        del initial
        out = os.path.join(tmp.name, "songsplat")
        lines = []
        peak_reset()
        run = ss.train_songsplat(iterations=c["warmup"] + c["steps"], tiny=c["tiny"], port=0,
                                 out=out, device=dev, log=lines.append)
        peak = peak_gib()
        timed_s = run.t_end - run.step_starts[c["warmup"]]
        step_ms = 1e3 * timed_s / c["steps"]
        losses = run.step_losses
        after = songsplat_fixed_loss(run.model, song)
        k = min(20, max(1, len(losses) // 3))
        print(f"models (a) song splat, train_songsplat at the reference configuration "
              f"({'--tiny' if c['tiny'] else 'full width'}), port 0, output in a temporary "
              f"directory: {c['warmup']} warm-up and {c['steps']} timed steps, "
              f"{c['steps'] / timed_s:.2f} steps/s ({step_ms:.1f} ms a step, host clock, ending "
              f"in a synchronisation); loss every step (read after the loop) "
              + ", ".join(f"{v:.1f}" for v in losses)
              + f" (means of the first and last {k}: {np.mean(losses[:k]):.1f}, "
              f"{np.mean(losses[-k:]):.1f}); the loss over the render's segments, one fixed "
              f"noise, {before:.1f} before and {after:.1f} after; peak memory {peak:.3f} GiB; "
              f"its log: " + " | ".join(lines))
        with open(os.path.join(out, "song_eval.json")) as f:
            print("models (a) song splat, song_eval.json " + json.dumps(json.load(f))
                  + "; the untrained model's render " + json.dumps(eval_before))
        lsd = (eval_before["covered_lsd_db"], run.eval["covered_lsd_db"])
        if not np.isfinite(losses).all() or not after < before or not lsd[1] < lsd[0]:
            fail(f"models: a song splat step's loss is not finite, or the loss over the "
                 f"render's segments ({before:.2f}, {after:.2f}) or its covered LSD "
                 f"({lsd[0]:.3f}, {lsd[1]:.3f} dB) did not fall")
        t0 = time.perf_counter()
        _, refit = ss.render_song(run.model, song, 1e-3, device=dev)
        print(f"models (a) song splat, the whole song rendered with the gain refit at ridge "
              f"1e-3: {json.dumps(refit)} ({(time.perf_counter() - t0) * 1e3:.0f} ms)")
        if on_card:
            adam = Adam(1e-3)
            st = adam.init(list(run.model.parameters()))
            tgt, sf2 = next(ss.segment_stream(torch.from_numpy(song).to(dev), run.model, seed=1))
            nz = uniform(run.model.noise_shape, -1.0, 1.0,
                         torch.Generator(device=dev).manual_seed(1))
            ss.songsplat_step(run.model, adam, st, tgt, sf2, nz)   # Adam's state warm
            traced = device_time_by_kernel(
                lambda: ss.songsplat_step(run.model, adam, st, tgt, sf2, nz), sync)
            print(f"models (a) song splat, one step traced: {traced[2]} kernel launches")
            print(busy_line("song splat step, traced", traced, step_ms))
        else:
            print("models (a) song splat, trace and peak memory not measured (no card)")
        del run

        # (b) the instrument at sw6's shapes
        c = cfg["instrument"]
        n = c["n_samples"]
        sizes = dict(n_samples=n, n_events=c["n_events"], hidden=c["hidden"],
                     context_dim=c["context_dim"], window=c["window"])
        inst = build_instrument(None, size_overrides=sizes, device=dev)
        lines = []
        inst.add_note(inst.random_vector(99), 0.0)
        inst.render()   # warm-up
        inst.clear()
        sync()
        t0 = time.perf_counter()
        phrase = demo_phrase(inst, os.path.join(tmp.name, "random.wav"), log=lines.append)
        sync()
        random_ms = (time.perf_counter() - t0) * 1e3

        def render_ms():
            """ms a note of rendering the queued notes again."""
            t0 = time.perf_counter()
            inst.render()
            sync()
            return (time.perf_counter() - t0) * 1e3 / len(inst.notes)

        random_note_ms = render_ms()
        window = synthetic_audio(c["walk_samples"], 22050, n_events=c["audio_events"], seed=3,
                                 sustained=True)[:n]
        wav = os.path.join(tmp.name, "window.wav")
        write_wav(wav, window)
        inst = build_instrument(None, size_overrides=sizes, device=dev)
        x = torch.from_numpy(window).reshape(1, 1, -1).to(dev)
        inst.harvest_bank(x)   # warm-up
        sync()
        t0 = time.perf_counter()
        inst.harvest_bank(x)
        sync()
        harvest_ms = (time.perf_counter() - t0) * 1e3
        inst.bank = None
        t0 = time.perf_counter()
        bank_phrase = demo_phrase(inst, os.path.join(tmp.name, "bank.wav"), harvest_wav=wav,
                                  log=lines.append)
        sync()
        bank_ms = (time.perf_counter() - t0) * 1e3
        bank_note_ms = render_ms()
        print(f"models (b) instrument at {n} samples, {c['n_events']} events, hidden "
              f"{c['hidden']}, context {c['context_dim']}, STFT {c['window']}/256 (seeded "
              f"parameters): demo_phrase of 5 random notes {random_ms:.1f} ms (the gain and "
              f"WAV included), {phrase.shape[-1]} samples, their render again "
              f"{random_note_ms:.2f} ms a note; a harvest (the codec's encode of one window) "
              f"{harvest_ms:.1f} ms; demo_phrase of 7 bank notes {bank_ms:.1f} ms (its own "
              f"harvest included), {bank_phrase.shape[-1]} samples, their render again "
              f"{bank_note_ms:.2f} ms a note (host clock, each ending in a synchronisation); "
              f"its log: " + " | ".join(lines))
        if not (np.isfinite(phrase).all() and np.isfinite(bank_phrase).all()
                and np.abs(bank_phrase).max() > 0):
            fail("models: an instrument phrase is not finite or silent")
        # the card against the CPU: the same parameters, codec noise, window and note noise
        host_inst = build_instrument(None, size_overrides=sizes, device=cpu)
        host_inst.model.load_state_dict({k: v.cpu() for k, v in inst.model.state_dict().items()})
        host_inst.codec.noise = inst.codec.noise.cpu()
        enc, host_enc = inst.codec.encode(x), host_inst.codec.encode(x.cpu())
        same_frames = torch.equal(enc.schedules.argmax(-1).cpu(), host_enc.schedules.argmax(-1))
        vec_err = share_err(enc.vecs, host_enc.vecs)
        note_noise = draw_noise(inst.model, (len(inst.notes), 1), torch.Generator().manual_seed(5))
        card_audio = inst.render(noise=note_noise.to(dev))
        host_audio = host_inst.render(notes=inst.notes, noise=note_noise)
        audio_err = share_err(torch.from_numpy(card_audio), torch.from_numpy(host_audio))
        print(f"models (b) instrument, card against CPU: the harvested bank's frames "
              f"{'identical' if same_frames else 'DIFFERENT'}, its vectors {vec_err:.2e} of the "
              f"largest; the 7-note phrase from the same vectors and noise {audio_err:.2e} of its "
              f"largest")
        if not same_frames or audio_err > MODELS_TOL["audio"]:
            fail(f"models: the instrument's bank frames differ or its phrase is {audio_err:.2e} "
                 f"from the CPU's")
        del inst, host_inst, enc, host_enc

        # (c) index_corpus at build_index.py's defaults
        c = cfg["index"]
        if any(kernels.LAUNCHES.values()):
            fail(f"models: (a) and (b) launched kernels: {kernels.LAUNCHES}")
        embed = make_embedder(c["chunk_size"], device=dev)
        chunks = [ch for _, (_, ch) in zip(range(c["chunks"]), iter_audio_segments(
            None, "*.wav", c["chunk_size"], rng=np.random.default_rng(0)))]   # the corpus written
        embed(chunks[0])   # warm-up
        sync()
        before = kernels.LAUNCHES[K4]
        lines = []
        t0 = time.perf_counter()
        index = index_corpus(chunks=c["chunks"], chunk_size=c["chunk_size"],
                             index_path=os.path.join(tmp.name, "search_index"), embed=embed,
                             rng=np.random.default_rng(0), device=dev, log=lines.append)
        sync()
        index_ms = (time.perf_counter() - t0) * 1e3
        k4 = kernels.LAUNCHES[K4] - before
        if records is not None:
            records[K4]["launches_build_index"] = k4
        # the first chunk that is not silent (a silent chunk embeds as zeros)
        live = next((i for i in range(len(index.keys)) if index.embeddings[i].abs().max() > 0),
                    None)
        if live is None:
            fail("models: every indexed chunk embeds as zeros")
        by_band, gate, checked = {}, {}, {}
        signal = fft_frequency_decompose(torch.from_numpy(chunks[live]).to(dev),
                                         embed.model.min_size)
        for size, spec in embed.model.bands.items():
            b0 = kernels.LAUNCHES[K4]
            spec.encode(signal[size], embed.steps)
            by_band[size] = kernels.LAUNCHES[K4] - b0
            geom = fast_geometry(size, spec.atom_size, 128)
            gate[size] = fused_step_applicable(size, spec.atom_size, 128, geom.pad, spec.n_atoms,
                                               dev)
        counted = dict(kernels.LAUNCHES)
        for size, spec in embed.model.bands.items():
            # the cluster step kernel at this band's shapes against the
            # one-block kernel and the plain version, from the same state;
            # on the CPU every wrapper takes the plain version
            if on_card and not gate[size]:
                continue
            geom = fast_geometry(size, spec.atom_size, 128)
            d2 = unit_norm(spec.d)
            gram_p = F.pad(dictionary_gram(d2), (0, 1))
            fm, bm, res = encode_state(signal[size], d2, geom)
            bm = F.pad(bm, (0, geom.nb_pad - geom.n_blocks), value=-3e38)
            checked[size] = cluster_step_check(f"models (c), band {size}", (fm, bm, res), d2,
                                               gram_p, geom._asdict(), embed.steps, sync)
        kernels.LAUNCHES.update(counted)   # the checks' launches do not count
        print(f"models (c) index_corpus, {len(index.keys)} chunks of {c['chunk_size']} samples "
              f"from the demo corpus (a temporary MPTPU_CACHE): {index_ms:.1f} ms, "
              f"{index_ms / len(index.keys):.2f} ms a chunk (host clock, the index written "
              f"included); {k4} launches of {K4} ({k4 / max(1, len(index.keys)):.0f} a chunk); "
              f"chunk {live} ({index.keys[live]}, the first not silent) again, launches by band: "
              + ", ".join(f"{s}: {v}" for s, v in by_band.items())
              + "; the fused gate by band (block 128): "
              + ", ".join(f"{s}: {g}" for s, g in gate.items())
              + "; its log: " + " | ".join(lines))
        print(f"check {K4} at index_corpus's bands (chunk {live}, {embed.steps} steps): clusters "
              f"of 1 to 16, step by step and as chains, bit-identical to the one-block kernel, "
              f"whose events equal the plain version's at every step; max abs err vs plain, "
              f"clipped events, by band: "
              + ", ".join(f"{s}: {e:.3e}, {n}" for s, (e, n) in checked.items()))
        if on_card and (not checked or set(checked) != {s for s, g in gate.items() if g}):
            fail(f"models: the cluster step kernel was checked at bands {sorted(checked)}, the "
                 f"gate passes {sorted(s for s, g in gate.items() if g)}")
        # the script's seed-0 query, for the log (it may pick a silent chunk,
        # which finds any other silent chunk first); then the first chunk that
        # is not silent must find itself first at distance 0 and the next
        # result further away
        search = BruteForceSearch(index.embeddings, index.keys, n_results=4, device=dev)
        found, embs = search.search(index.embeddings[live])
        dist = torch.linalg.vector_norm(embs - index.embeddings[live], dim=-1).tolist()
        print(f"models (c) index_corpus, the script's query {index.query_key} found "
              f"{index.result_keys}; chunk {live} {index.keys[live]} found "
              + ", ".join(f"{k} at {d:.6g}" for k, d in zip(found, dist)))
        if found[0] != index.keys[live] or dist[0] != 0.0 or not dist[1] > 0.0:
            fail(f"models: chunk {index.keys[live]} did not find itself first at distance 0 "
                 f"with the next further away ({found}, {dist})")
        if on_card and k4 == 0:
            fail(f"models: index_corpus launched {K4} no time")
        host_embed = make_embedder(c["chunk_size"], device=cpu)
        same_events, all_events, gaps = 0, 0, []
        for ch in chunks[: c["cpu_chunks"]]:
            tuples = [emb.model.flattened_event_tuples(
                emb.model.encode(torch.from_numpy(ch).to(d), emb.steps))
                for emb, d in ((embed, dev), (host_embed, cpu))]
            (gi, ut, _), (hgi, hut, _) = tuples
            same = (gi.cpu() == hgi) & (ut.cpu() == hut)
            same_events += int(same.sum())
            all_events += same.numel()
            want = host_embed(ch)   # a silent chunk embeds as zeros
            gaps.append(float(np.abs(embed(ch) - want).max()) / max(float(np.abs(want).max()),
                                                                    1e-30))
        print(f"models (c) index_corpus, card against CPU on {c['cpu_chunks']} chunks: "
              f"{same_events} of {all_events} events identical (atom and time); the largest "
              f"embedding gap {max(gaps):.2e} of the largest")
        if same_events == all_events and max(gaps) > MODELS_TOL["embedding"]:
            fail(f"models: the same events embed {max(gaps):.2e} apart")
        after_c = dict(kernels.LAUNCHES)
        del embed, host_embed, index, chunks

        # (d) the learned-atom MP
        c = cfg["mp"]
        audio = torch.from_numpy(synthetic_audio(c["n_samples"], 22050, n_events=8, seed=1,
                                                 sustained=True)).reshape(1, 1, -1)

        def transform(v):
            return stft(v, 2048, 256, pad=True)

        def build_mp(device):
            return MatchingPursuit(c["n_atoms"], c["atom_samples"], c["n_samples"],
                                   c["iterations"], device=device)

        mp_state = build_mp(cpu).state_dict()

        def mp_once(device, dtype):
            m = build_mp(device)
            m.load_state_dict(mp_state)
            m.to(dtype)
            a = audio.to(device, dtype)
            ch, atoms, times = m(a, return_events=True)
            loss = iterative_loss(a, ch, transform)
            (g,) = torch.autograd.grad(loss, [m.atoms])
            return ch.detach().cpu(), atoms.cpu(), times.cpu(), float(loss.detach()), g.cpu()

        mp_runs = {(d.type, dt): mp_once(d, dt) for d in (dev, cpu)
                   for dt in (torch.float32, torch.float64)}
        (cc, ca, ct, cl, cg), (hc, ha, ht, hl, hg) = (mp_runs[(dev.type, torch.float32)],
                                                      mp_runs[("cpu", torch.float32)])
        c64, h64 = mp_runs[(dev.type, torch.float64)], mp_runs[("cpu", torch.float64)]
        same = (torch.equal(ca, ha) and torch.equal(ct, ht) and torch.equal(c64[1], h64[1])
                and torch.equal(c64[2], h64[2]))
        ch_err, g64, g32 = share_err(cc, hc), share_err(c64[4], h64[4]), share_err(cg, hg)
        a = audio.to(dev)
        scale = float(transform(audio).abs().sum())   # the target feature's l1 norm
        trained, mp_ms, mp_peak = {}, None, None
        for lr, want in c["reference"].items():
            m = build_mp(dev)
            m.load_state_dict(mp_state)
            opt = torch.optim.Adam(m.parameters(), lr=lr)
            losses, starts = [], []
            peak_reset()
            for _ in range(len(want)):
                starts.append(time.perf_counter())
                opt.zero_grad(set_to_none=True)
                loss = iterative_loss(a, m(a), transform)
                loss.backward()
                opt.step()
                losses.append(loss.detach())
            sync()
            if mp_ms is None:   # the first learning rate's steps are the ones timed
                mp_ms = 1e3 * (time.perf_counter() - starts[1]) / (len(want) - 1)
                mp_peak = peak_gib()
            trained[lr] = torch.stack(losses).tolist()

        def mp_step():
            opt.zero_grad(set_to_none=True)
            iterative_loss(a, m(a), transform).backward()
            opt.step()
        print(f"models (d) learned-atom MP, {c['n_atoms']} atoms x {c['atom_samples']} samples, "
              f"{c['n_samples']} samples, {c['iterations']} iterations, batch 1: card against "
              f"CPU from one state_dict: atoms and times of every iteration "
              f"{'identical' if same else 'DIFFERENT'} (float32 and float64), channels "
              f"{ch_err:.2e} of the largest, loss {cl:.6g} against {hl:.6g}, gradients "
              f"float64 {g64:.2e}, float32 {g32:.2e} of the largest; Adam steps, "
              f"{mp_ms:.1f} ms a step (host clock, after the first), peak memory "
              f"{mp_peak:.3f} GiB")
        if on_card:
            traced = device_time_by_kernel(mp_step, sync)
            print(f"models (d) learned-atom MP, one step traced: {traced[2]} kernel launches")
            print(busy_line("learned-atom MP step, traced", traced, mp_ms))
        if not same or ch_err > MODELS_TOL["audio"] or g64 > MODELS_TOL["gradients64"]:
            fail(f"models: the learned-atom MP differs from the CPU (events identical {same}, "
                 f"channels {ch_err:.2e}, float64 gradients {g64:.2e})")
        # mptpu's loss rises at lr 1e-2 at these widths and falls at lr 1e-3
        for lr, losses in trained.items():
            trajectory_check(f"models (d) learned-atom MP, lr {lr:g}", losses,
                             c["reference"][lr], MODELS_TOL["trajectory"], lr == c["falls_at"],
                             scale, "the target feature's l1 norm")

        # (e) no kernel but the cluster step kernel, and that one in (c) alone
        launches = dict(kernels.LAUNCHES)
        if launches != after_c or any(v for name, v in launches.items() if name != K4):
            fail(f"models phase: launches {launches}, expected {K4} alone, in (c)")
        print(f"models launches {launches}; the phase took {time.perf_counter() - t_phase:.1f} s "
              f"(host clock)")
    finally:
        for key, v in saved.items():
            if v is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = v
        tmp.cleanup()


def trajectory_check(name, losses, reference, tol, falls, scale=None,
                     scale_name="mptpu's largest loss"):
    """Hold a trajectory of losses to ``mptpu``'s: every step within ``tol``
    of ``scale`` (mptpu's largest loss unless given; ``scale_name`` says
    what it is); where ``falls``, the median of the last quarter (at least
    3 steps) below the median of the first (a median of 3 or more, so that
    no one spike carries it). ``name`` starts with the phase. Returns the
    largest gap."""
    m, p = np.asarray(reference, np.float64), np.asarray(losses, np.float64)
    if len(p) != len(m) or not np.isfinite(p).all():
        fail(f"{name}: {len(p)} losses (finite: {np.isfinite(p).all()}), mptpu's trajectory "
             f"has {len(m)}")
    scale = float(np.abs(m).max()) if scale is None else scale
    gap = float(np.abs(p - m).max() / scale)
    q = max(3, len(m) // 4)
    first, last = float(np.median(p[:q])), float(np.median(p[-q:]))
    print(f"{name}: loss every step " + ", ".join(f"{v:.7g}" for v in p)
          + f"; mptpu's trajectory {gap:.2e} of {scale_name} ({scale:.7g}) away at most (gate "
          f"{tol:g}); medians of the first and last {q}: {first:.7g} -> {last:.7g}"
          + (f" (mptpu's {np.median(m[:q]):.7g} -> {np.median(m[-q:]):.7g}, which falls: "
             f"gated on a fall)" if falls else ""))
    if gap > tol:
        fail(f"{name}: {gap:.2e} of {scale_name} from mptpu's trajectory (gate {tol:g})")
    if falls and not last < first:
        fail(f"{name}: the loss did not fall ({first:.7g} -> {last:.7g}), where mptpu's falls")
    return gap


def grads_err(a, b):
    """The largest of ``share_err`` over the parameters (named alike)."""
    return max(share_err(a[k], b[k]) for k in b)


def one_step_both(build, loss_of, dev):
    """{(device type, dtype name): (loss, {parameter: gradient})} of one
    forward and backward: ``build(device)`` returns the model (the same
    parameters on every device), ``loss_of(model, device, dtype)`` its
    loss on the batch moved there."""
    import torch

    out = {}
    for d in (dev, torch.device("cpu")):
        for name in ("float32", "float64"):
            dtype = getattr(torch, name)
            m = build(d).to(dtype)
            loss = loss_of(m, d, dtype)
            names, params = zip(*m.named_parameters())
            grads = torch.autograd.grad(loss, params, allow_unused=True, materialize_grads=True)
            out[(d.type, name)] = (float(loss.detach()), dict(zip(names, grads)))
            del m
    return out


def peak_reset(dev):
    """Reset the card's peak-memory counter (nothing off a card)."""
    import torch

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def peak_gib(dev) -> str:
    """Peak memory since the last reset, as text ("not measured" off a card)."""
    import torch

    if dev.type != "cuda":
        return "not measured (no card)"
    return f"{torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB"


def host_step_ms(starts, t_end) -> float:
    """ms a step by the host clock, after the first (warm-up) step."""
    return 1e3 * (t_end - starts[1]) / (len(starts) - 1)


def traced_step(label, fn, step_ms, dev, sync):
    """One call of ``fn`` (a step) traced: its launches, its device-busy
    time and idle share against ``step_ms``; off a card the step runs
    untraced, so that a rehearsal reaches it."""
    if dev.type != "cuda":
        fn()
        print(f"{label}: trace not measured (no card)")
        return
    traced = device_time_by_kernel(fn, sync)
    print(f"{label}, one step traced: {traced[2]} kernel launches")
    print(busy_line(f"{label}, traced", traced, step_ms))


def card_against_cpu(label, runs, dev, loss_tol, grad_tol, loss_scale=None):
    """Hold ``one_step_both``'s runs: the float32 loss within ``loss_tol``
    of the CPU's (of ``loss_scale``, the magnitude it is held against where
    it is a difference of nearly equal terms; default the loss), the
    float64 loss and gradients (of each parameter's largest) within
    ``grad_tol``."""
    (l32, g32), (h32, hg32) = runs[(dev.type, "float32")], runs[("cpu", "float32")]
    (l64, g64), (h64, hg64) = runs[(dev.type, "float64")], runs[("cpu", "float64")]
    loss_rel = abs(l32 - h32) / (loss_scale or abs(h32))
    loss64 = abs(l64 - h64) / abs(h64)
    e32, e64 = grads_err(g32, hg32), grads_err(g64, hg64)
    print(f"{label}, one step on the card against the CPU from the same parameters and "
          f"inputs: loss {l32:.7g} against {h32:.7g} ({loss_rel:.2e} of "
          f"{'the terms, ' + format(loss_scale, '.6g') if loss_scale else 'it'}; float64 "
          f"{loss64:.2e}); gradients, max abs err over the largest of each parameter: float64 "
          f"{e64:.2e}, float32 {e32:.2e} (gates: loss {loss_tol:g}, float64 gradients and loss "
          f"{grad_tol:g})")
    if loss_rel > loss_tol or e64 > grad_tol or loss64 > grad_tol:
        fail(f"{label}: the card's step is off the CPU's (loss {loss_rel:.2e}, float64 loss "
             f"{loss64:.2e}, float64 gradients {e64:.2e})")


def longtail_phase(dev, cfg, sync):
    """Phase 11, the long-tail models (ROADMAP A11) at their scripts'
    defaults and the A4 layers, launch counts set to 0 first and read last:
    (a) ``simulate_room`` at scripts/roomsim.py's defaults, the card
    against the CPU, then ``overfit_room`` held to ``mptpu``'s trajectory;
    (b) ``train_textural``, (c) ``train_funcsong`` and (d)
    ``train_audiooperator`` (random batches and ``--overfit``) at their
    scripts' defaults, each after one step on the card against the CPU
    from the same parameters and batch, each trajectory held to
    ``mptpu``'s (tests/reference/*_trajectory.py); (e) the A4 layers and the
    multiresolution shells at small sizes, the card against the CPU in
    float64; none of the six kernels launched. Each of (a) to (d) prints
    its ms a step, launches, device-busy time and idle share (one traced
    step) and peak memory."""
    import importlib
    import os
    import tempfile

    import torch

    from mptpu_torch import kernels
    from mptpu_torch.models import audiooperator as tao
    from mptpu_torch.models import funcsong as tfs
    from mptpu_torch.models import textural as ttx
    from mptpu_torch.ops.stft import stft
    from mptpu_torch.train.optim import Adam

    troom = importlib.import_module("mptpu_torch.gen.roomsim")
    on_card = dev.type == "cuda"
    cpu = torch.device("cpu")
    ref, tol = cfg["reference"], dict(LONGTAIL_TOL, **cfg.get("tol", {}))
    quiet = lambda s: None   # noqa: E731
    tmp = tempfile.TemporaryDirectory()

    try:
        kernels.reset_launches()
        t_phase = time.perf_counter()

        # (a) the room
        c = cfg["room"]
        size = dict(block_size=c["block"], n_frames=c["frames"], width=c["width"],
                    height=c["height"], depth=c["depth"])
        troom.simulate_room(**size, device=dev, log=quiet)   # warm-up
        peak_reset(dev)
        sims = [troom.simulate_room(**size, device=dev, log=quiet) for _ in range(3)]
        sim_peak = peak_gib(dev)
        host_sim = troom.simulate_room(**size, device=cpu, log=quiet)
        rec_err = share_err(sims[-1].recording, host_sim.recording)
        frames_err = share_err(sims[-1].frames, host_sim.frames)
        sim_ms = [1e3 * s.seconds for s in sims]
        print(f"longtail (a) simulate_room at {c['block']} x {c['frames']} frames, "
              f"{c['width']} x {c['height']} x {c['depth']} voxels: "
              + ", ".join(f"{v:.1f}" for v in sim_ms)
              + f" ms a simulation (host clock, ending in a synchronisation; the CPU's "
              f"{1e3 * host_sim.seconds:.1f} ms); peak memory {sim_peak}; card against "
              f"CPU: recording {rec_err:.2e}, frames {frames_err:.2e} of the peak (gate "
              f"{tol['room']:g})")
        if rec_err > tol["room"] or frames_err > tol["room"]:
            fail(f"longtail: the room's recording ({rec_err:.2e}) or frames ({frames_err:.2e}) "
                 f"off the CPU's")
        t_in = torch.from_numpy(sims[-1].transfer.astype(np.float32)).to(dev)
        c_in = torch.from_numpy(sims[-1].control).to(dev)

        def simulate():
            with torch.no_grad():
                troom.roomsim(t_in, c_in)

        traced_step("longtail (a) simulate_room", simulate, min(sim_ms), dev, sync)
        rec = sims[-1].recording
        target = (rec / (rec.abs().max() + 1e-9)).reshape(1, 1, -1)
        peak_reset(dev)
        fit = troom.overfit_room(target, c["room"], c["block"], c["frames"], c["steps"], c["lr"],
                                 device=dev, log=quiet)
        fit_peak = peak_gib(dev)
        ms = host_step_ms(fit.step_starts, fit.t_end)
        print(f"longtail (a) overfit_room at {c['room']} x {c['room']}, {c['frames']} frames, lr "
              f"{c['lr']:g}: {c['steps']} steps, {ms:.1f} ms a step (host clock, after the first); "
              f"peak memory {fit_peak}")
        trajectory_check("longtail (a) overfit_room", fit.losses, ref["roomsim"],
                         tol["trajectory"], falls(ref["roomsim"]))
        adam = Adam(c["lr"])
        st = adam.init(list(fit.model.parameters()))

        def room_step():
            params = list(fit.model.parameters())
            grads = torch.autograd.grad(troom.room_loss(fit.model, target), params)
            updates, _ = adam.update(grads, st)
            with torch.no_grad():
                torch._foreach_add_(params, updates)

        traced_step("longtail (a) overfit_room", room_step, ms, dev, sync)
        del sims, host_sim, fit

        # (b) the textural model
        c = cfg["textural"]
        size = dict(ttx.SMOKE) if c["smoke"] else dict(n_samples=2**16, n_events=64, n_atoms=64,
                                                       atom_size=2048)
        seg = torch.from_numpy(ttx.textural_target(size["n_samples"])).reshape(1, 1, -1)
        state = ttx.TexturalModel(latent_dim=16, device=cpu, **size).state_dict()

        def build_textural(d):
            m = ttx.TexturalModel(latent_dim=16, device=d, **size)
            m.load_state_dict(state)
            return m

        card_against_cpu("longtail (b) textural", one_step_both(
            build_textural, lambda m, d, dt: ttx.textural_loss(
                m, stft(seg.to(d, dt), 2048, 256, pad=True))[0], dev),
            dev, tol["loss"], tol["gradients64"])
        peak_reset(dev)
        run = ttx.train_textural(iterations=c["steps"], smoke=c["smoke"],
                                 out=os.path.join(tmp.name, "textural"), device=dev, log=quiet)
        tex_peak = peak_gib(dev)
        ms = host_step_ms(run.step_starts, run.t_end)
        print(f"longtail (b) train_textural at {size['n_samples']} samples, "
              f"{size['n_events']} events, {size['n_atoms']} x {size['atom_size']} atoms, latent "
              f"16: {c['steps']} steps, {ms:.1f} ms a step (host clock, after the first); peak "
              f"memory {tex_peak}")
        trajectory_check("longtail (b) train_textural", run.losses, ref["textural"],
                         tol["trajectory"], falls(ref["textural"]))
        adam = Adam(1e-3)
        st = adam.init(list(run.model.parameters()))
        tspec = stft(seg.to(dev), 2048, 256, pad=True)
        traced_step("longtail (b) train_textural",
                    lambda: ttx.textural_step(run.model, adam, st, tspec), ms, dev, sync)
        del run

        # (c) the functional song
        c = cfg["funcsong"]
        s = tfs.SMOKE if c["smoke"] else dict(segment_samples=2**15, pos_channels=256,
                                              hidden=256, layers=4, batch_size=4)
        n, ch = s["segment_samples"], s["pos_channels"]
        song = torch.from_numpy(tfs.funcsong_song())
        starts = torch.from_numpy(np.random.default_rng(0).integers(   # the first crop of the
            0, song.shape[-1] - n, size=s["batch_size"])[:1])           # trainer's first batch
        f_target, f_pos = tfs.crop_batch(song, starts, n, ch)   # on the CPU, moved to both
        state = tfs.FuncSong(n, ch, s["hidden"], s["layers"], device=cpu).state_dict()

        def build_funcsong(d):
            m = tfs.FuncSong(n, ch, s["hidden"], s["layers"], device=d)
            m.load_state_dict(state)
            return m

        card_against_cpu("longtail (c) funcsong, the first crop", one_step_both(
            build_funcsong, lambda m, d, dt: tfs.funcsong_loss(
                m, f_target.to(d, dt), f_pos.to(d, dt))[0], dev),
            dev, tol["funcsong_loss"], tol["funcsong_gradients64"])
        peak_reset(dev)
        run = tfs.train_funcsong(iterations=c["steps"], smoke=c["smoke"],
                                 out=os.path.join(tmp.name, "funcsong"), device=dev, log=quiet)
        fs_peak = peak_gib(dev)
        ms = host_step_ms(run.step_starts, run.t_end)
        print(f"longtail (c) train_funcsong, a {run.total_samples}-sample song, crops of {n}, "
              f"batch {s['batch_size']}, {ch} position channels, hidden {s['hidden']}, "
              f"{s['layers']} layers, 64 resonances ({run.n_params} parameters): {c['steps']} "
              f"steps, {ms:.1f} ms a step (host clock, after the first); peak memory "
              f"{fs_peak}")
        trajectory_check("longtail (c) train_funcsong", run.losses, ref["funcsong"],
                         tol["funcsong_trajectory"], falls(ref["funcsong"]))
        # the frozen control: the seed-0 model's loss on each step's crops (those the trainer
        # drew) with no update; the rise over it is the gate that a run must train to pass
        frozen, song_d, rng = build_funcsong(dev), song.to(dev), np.random.default_rng(0)
        with torch.no_grad():
            control = torch.stack([tfs.funcsong_loss(frozen, *tfs.crop_batch(
                song_d, torch.from_numpy(rng.integers(0, song.shape[-1] - n,
                                                      size=s["batch_size"])), n, ch))[0]
                for _ in range(c["steps"])]).tolist()
        rise, want = rise_over(run.losses, control), rise_over(ref["funcsong"],
                                                               ref["funcsong_control"])
        lo, hi = tol["funcsong_rise"]
        print(f"longtail (c) the frozen control on the same crops: loss every step "
              + ", ".join(f"{v:.7g}" for v in control) + f"; the run's rise over it {rise:.4f}, "
              f"mptpu's {want:.4f}, {rise / want:.3f} of it (gate {lo:g} to {hi:g}"
              + ("" if c["control"] else "; not gated at this size") + ")")
        if c["control"] and not lo <= rise / want <= hi:
            fail(f"longtail: (c) train_funcsong rose {rise:.4f} over the frozen control, "
                 f"{rise / want:.3f} of mptpu's {want:.4f} (gate {lo:g} to {hi:g})")
        del frozen, song_d
        adam = Adam(1e-3)
        st = adam.init(list(run.model.parameters()))
        tgt, pos = f_target.to(dev), f_pos.to(dev)
        traced_step("longtail (c) train_funcsong",
                    lambda: tfs.funcsong_step(run.model, adam, st, tgt, pos), ms, dev, sync)
        del run

        # (d) the audio operator
        c = cfg["operator"]
        w = dict(tao.SMOKE) if c["smoke"] else dict(
            n_samples=2**15, n_bands=512, model_dim=512, envelope_resolution=128, latent_dim=64,
            pool_window=512, pool_step=128)
        n, ref_n = w["n_samples"], c["reference_samples"]
        nb, er, ld = w["n_bands"], w["envelope_resolution"], w["latent_dim"]
        batch = tao.make_batch(torch.Generator().manual_seed(0), 4, n, nb, 2048.0, er, ld, cpu)
        enc = tao.times_encoding(4, n, nb, 2048.0, cpu)
        state = tao.AudioOperator(er, ld, 2 * nb, w["model_dim"], device=cpu).state_dict()

        def build_operator(d):
            m = tao.AudioOperator(er, ld, 2 * nb, w["model_dim"], device=d)
            m.load_state_dict(state)
            return m

        # the envelope loss is the difference of two sums of pooled norms, nearly equal
        # while the recon is small: its float32 rounding is held against the sum of the
        # target's pooled norms (its terms), as tests/test_torch_longtail.py holds it
        pooled = torch.nn.functional.avg_pool1d(batch[0].double().abs(), w["pool_window"],
                                                w["pool_step"], padding=w["pool_step"],
                                                count_include_pad=True)
        terms = float(torch.linalg.vector_norm(pooled, dim=-1).sum())
        card_against_cpu(f"longtail (d) audiooperator at {n} samples", one_step_both(
            build_operator, lambda m, d, dt: tao.operator_loss(
                m, tuple(b.to(d, dt) for b in batch), enc.to(d, dt), w["pool_window"],
                w["pool_step"]), dev),
            dev, tol["loss"], tol["gradients64"], loss_scale=terms)
        for overfit in (False, True):
            label = "--overfit" if overfit else "random batches"
            peak_reset(dev)
            run = tao.train_audiooperator(iterations=c["steps"], overfit=overfit, out=None,
                                          device=dev, log=quiet, **w)
            op_peak = peak_gib(dev)
            ms = host_step_ms(run.step_starts, run.t_end)
            print(f"longtail (d) train_audiooperator ({label}) at {w['n_samples']} samples, "
                  f"{nb} bands, model {w['model_dim']}, latent {ld}, envelope {er}, batch 4, "
                  f"pool {w['pool_window']}/{w['pool_step']}: {c['steps']} steps, {ms:.1f} ms a "
                  f"step (host clock, after the first), loss every step "
                  + ", ".join(f"{v:.6g}" for v in run.losses) + f"; peak memory "
                  f"{op_peak}")
            if not np.isfinite(run.losses).all():
                fail(f"longtail: train_audiooperator ({label}) gave a loss that is not finite")
            if not overfit:
                adam = Adam(1e-3)
                st = adam.init(list(run.model.parameters()))
                b = tao.make_batch(torch.Generator().manual_seed(1), 4, w["n_samples"], nb,
                                   2048.0, er, ld, dev)
                full_enc = tao.times_encoding(4, w["n_samples"], nb, 2048.0, dev)
                traced_step(f"longtail (d) train_audiooperator at {w['n_samples']} samples",
                            lambda: tao.operator_step(run.model, adam, st, b, full_enc,
                                                      w["pool_window"], w["pool_step"]),
                            ms, dev, sync)
                del b, full_enc
            del run
            key = "operator_overfit" if overfit else "operator_random"
            run = tao.train_audiooperator(iterations=len(ref[key]), overfit=overfit, out=None,
                                          device=dev, log=quiet, **dict(w, n_samples=ref_n))
            trajectory_check(f"longtail (d) train_audiooperator ({label}) at {ref_n} samples",
                             run.losses, ref[key], tol.get(f"{key}_trajectory", tol["trajectory"]),
                             falls(ref[key]))
            del run

        # (e) the A4 layers and the multiresolution shells, card against CPU in float64
        layers_check(dev)

        launches = dict(kernels.LAUNCHES)
        if any(launches.values()):
            fail(f"longtail phase: launches {launches}, expected none")
        print(f"longtail launches of the six kernels {launches} (none expected); the phase took "
              f"{time.perf_counter() - t_phase:.1f} s (host clock)")
    finally:
        tmp.cleanup()


def rise_over(losses, control) -> float:
    """How far a run's loss stands above a frozen control's on the same
    batches: the median over the last half of the steps of loss / control,
    less 1 (0 for the control itself)."""
    ratio = np.asarray(losses, np.float64) / np.asarray(control, np.float64)
    return float(np.median(ratio[len(ratio) // 2:]) - 1.0)


def falls(reference) -> bool:
    """Whether mptpu's trajectory falls: the median of its last quarter below
    the median of its first."""
    m = np.asarray(reference, np.float64)
    q = max(3, len(m) // 4)
    return bool(np.median(m[-q:]) < np.median(m[:q]))


def layers_check(dev):
    """Phase 11(e): each A4 layer, the five custom gradients, the phase codec
    and the multiresolution shells at a small size, forward and the
    gradient of ``sum(out * cotangent)`` by the parameters and inputs, on
    the card against the CPU in float64 (within LONGTAIL_TOL["layers"] of
    each tensor's largest; a tensor that is 0 in exact arithmetic below
    1e-12 of the case's largest)."""
    import torch

    from mptpu_torch import nn as tnn
    from mptpu_torch.models import multiresolution as tmr
    from mptpu_torch.ops import AudioCodec
    from mptpu_torch.ops import custom_grads as cg

    cpu = torch.device("cpu")
    gen = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(*shape, generator=gen, dtype=torch.float64)

    cases = {}
    ups = dict(latent_dim=6, channels=4, start_size=4, end_size=32, out_channels=2)
    for mode in ("nearest", "linear", "learned", "fft"):
        cases[f"ConvUpsample {mode}"] = (lambda d, mode=mode: tnn.ConvUpsample(
            **ups, mode=mode, device=d), [r(3, 6)], {})
    cases["ConvUpsample batch_norm, train"] = (lambda d: tnn.ConvUpsample(
        **ups, mode="learned", batch_norm=True, device=d), [r(3, 6)], dict(train=True))
    cases["ConvUpsample layer_norm"] = (lambda d: tnn.ConvUpsample(
        **ups, mode="nearest", layer_norm=True, device=d), [r(3, 6)], {})
    cases["UNet, train"] = (lambda d: tnn.UNet(6, out_channels=5, device=d), [r(2, 6, 128)],
                            dict(train=True))
    cases["UNet discriminator"] = (lambda d: tnn.UNet(6, is_disc=True, device=d),
                                   [r(2, 6, 128)], {})
    cases["DownsamplingDiscriminator"] = (lambda d: tnn.DownsamplingDiscriminator(
        64, 32, 1024, 8, device=d), [r(2, 1, 1024)], {})
    for pad in (None, "only-past", "only-future"):
        cases[f"DilatedStack {pad}"] = (lambda d, pad=pad: tnn.DilatedStack(
            6, (1, 3, 9), pad, device=d), [r(2, 6, 40)], {})
    cases["MixerStack"] = (lambda d: tnn.MixerStack(5, 8, 12, 2, 3, device=d), [r(2, 12, 5)], {})
    cases["Transformer"] = (lambda d: tnn.Transformer(16, 3, device=d), [r(2, 8, 16)], {})
    cases["MetaFormer"] = (lambda d: tnn.MetaFormer(8, 2, device=d), [r(2, 9, 8)], {})
    cases["AntiCausalAnalysis do_norm, train"] = (lambda d: tnn.AntiCausalAnalysis(
        5, 6, 2, (1, 2, 4), do_norm=True, device=d), [r(2, 5, 32)], dict(train=True))
    cases["DecoderShell"] = (lambda d: tmr.DecoderShell(8, (512, 1024), 1024, 16, device=d),
                             [r(2, 16)], {})
    feats = {512: r(2, 64 * 3 * 6), 1024: r(2, 64 * 3 * 4)}
    cases["EncoderShell"] = (lambda d: _DictInput(tmr.EncoderShell(8, {512: 6, 1024: 4}, 16,
                                                                   device=d)),
                             [feats[512], feats[1024]], {})
    def case_err(name, labels, card, host):
        """The largest error over a case's tensors (each of its largest), a
        tensor that is 0 in exact arithmetic (a bias before a batch norm in
        training: float64 noise on both sides) held below 1e-12 of the
        case's largest tensor instead; the tensors over the gate printed."""
        floor = 1e-12 * max(float(b.abs().max()) for b in host)
        worst, detail = 0.0, []
        for label, a, b in zip(labels, card, host):
            top = max(float(a.abs().max()), float(b.abs().max()))
            e = share_err(a, b) if top >= floor else 0.0
            worst = max(worst, e)
            if e > LONGTAIL_TOL["layers"]:
                detail.append(f"{label} {e:.2e} (largest {top:.3e})")
        if detail:
            print(f"longtail (e) {name}, tensors over the gate: " + "; ".join(detail))
        return worst

    errs = {}
    for name, (build, inputs, kw) in cases.items():
        state = build(cpu).state_dict()
        outs = {}
        for d in (dev, cpu):
            m = build(d)
            m.load_state_dict(state)
            m.double()
            xs = [x.to(d).requires_grad_() for x in inputs]
            out = m(*xs, **kw)
            cot = torch.randn(out.shape, generator=torch.Generator().manual_seed(1),
                              dtype=torch.float64).to(d)
            names, params = zip(*m.named_parameters())
            grads = torch.autograd.grad(torch.sum(out * cot), list(params) + xs,
                                        allow_unused=True, materialize_grads=True)
            outs[d.type] = [out.detach()] + list(grads)
        labels = ["output"] + [f"{n} gradient" for n in names] + [
            f"input {i} gradient" for i in range(len(inputs))]
        errs[name] = case_err(name, labels, outs[dev.type], outs["cpu"])
    # the phase codec's round trip and the five custom gradients
    audio = r(2, 4096)
    codec_out = {}
    for d in (dev, cpu):
        codec = AudioCodec(512, 256, device=d)
        codec.freqs = codec.freqs.double()
        codec_out[d.type] = codec.to_time_domain(codec.to_frequency_domain(audio.to(d)))
    errs["AudioCodec round trip"] = share_err(codec_out[dev.type], codec_out["cpu"])
    clips, pos, tgt = r(2, 3, 64), torch.rand(2, 3, generator=gen, dtype=torch.float64), r(2, 1, 64)
    palette, soft = r(64), torch.rand(20, generator=gen, dtype=torch.float64) * 2 - 1
    ops = {
        "position_render": (lambda c, p: cg.position_render(p, c, 64), [clips, pos * 0.9]),
        "scalar_position": (lambda p: cg.scalar_position(p, 64), [pos]),
        "differentiable_fft_shift": (lambda c, p: cg.differentiable_fft_shift(c, p[..., None]),
                                     [clips, pos]),
        "schedule_atoms": (lambda c, p: cg.schedule_atoms(c, p, tgt.to(c.device)), [clips, pos]),
        "diff_index": (lambda pal, s: cg.diff_index(pal, s), [palette, soft]),
    }
    for name, (fn, inputs) in ops.items():
        outs = {}
        for d in (dev, cpu):
            xs = [x.to(d).requires_grad_() for x in inputs]
            out = fn(*xs)
            cot = torch.randn(out.shape, generator=torch.Generator().manual_seed(2),
                              dtype=torch.float64).to(d)
            grads = torch.autograd.grad(out, xs, cot, allow_unused=True, materialize_grads=True)
            outs[d.type] = [out.detach()] + list(grads)
        labels = ["output"] + [f"input {i} gradient" for i in range(len(inputs))]
        errs[f"{name} (custom gradient)"] = case_err(name, labels, outs[dev.type], outs["cpu"])
    worst = max(errs.values())
    print("longtail (e) the A4 layers, the custom gradients, the phase codec and the "
          "multiresolution shells, card against CPU in float64, forward and gradients, max abs "
          "err over the largest: " + "; ".join(f"{k} {v:.1e}" for k, v in errs.items()))
    if worst > LONGTAIL_TOL["layers"]:
        fail(f"longtail: a layer is {worst:.2e} off the CPU in float64 "
             f"({max(errs, key=errs.get)})")


def perceptual_phase(dev, cfg, sync):
    """Phase 12, the perceptual stack, the remaining losses and the
    resonance chain (ROADMAP A5, A6), launch counts set to 0 first and read
    last: (a) ``overfit_resonance`` at scripts/resonance_overfit.py's
    defaults, after one step on the card against the CPU from the same
    parameters, target (``get_one_audio_segment(n, seed=9)`` off the demo
    corpus under a temporary MPTPU_CACHE) and noise, its trajectory held to
    ``mptpu``'s (tests/reference/resonance_trajectory.py, on its synthetic
    target and ``mptpu``'s draws); (b) ``run_phaseinvariance`` at the
    script's defaults, each transform's trajectory held to ``mptpu``'s; (c)
    ``synthesize_texture`` at the script's defaults with the texture and
    the scattering features, each after one step on the card against the
    CPU (the scattering features at 2^17 in float32 only, and gated on a
    fall), the texture trajectory held to ``mptpu``'s at 2^17 samples and
    the scattering one at ``--tiny``; (d) the A5 modules that no script reaches,
    the card against the CPU in float64; none of the six kernels launched.
    Each of (a) to (c) prints its ms a step, a traced step's launches,
    device-busy time and idle share, and its peak memory."""
    import os
    import tempfile

    import torch

    from mptpu_torch import kernels
    from mptpu_torch.data import get_one_audio_segment
    from mptpu_torch.data.synthetic import synthetic_audio
    from mptpu_torch.models import phaseinvariance as tpi
    from mptpu_torch.models import resonance_overfit as tro
    from mptpu_torch.models import texture as ttex
    from mptpu_torch.ops.norms import max_norm
    from mptpu_torch.train.optim import Adam, make_train_step

    on_card = dev.type == "cuda"
    cpu = torch.device("cpu")
    ref, tol = cfg["reference"], dict(PERCEPTUAL_TOL, **cfg.get("tol", {}))
    quiet = lambda s: None   # noqa: E731
    tmp = tempfile.TemporaryDirectory()
    saved = {k: os.environ.get(k) for k in ("MPTPU_CACHE", "AUDIO_PATH")}
    os.environ.pop("AUDIO_PATH", None)
    os.environ["MPTPU_CACHE"] = tmp.name

    class Waveform(torch.nn.Module):
        """texture's parameter, the raw waveform, as a module for
        ``one_step_both``."""

        def __init__(self, init):
            super().__init__()
            self.waveform = torch.nn.Parameter(init.clone())

    try:
        kernels.reset_launches()
        t_phase = time.perf_counter()

        # (a) the resonance overfit
        c = cfg["resonance"]
        n = 2**12 if c["tiny"] else 2**15
        noise = np.load(ROOT / "tests" / "reference" / "resonance_noise.npy")
        corpus = get_one_audio_segment(n, 22050, seed=9, device=cpu)
        state = tro.OverfitResonanceStack(n, device=cpu).state_dict()

        def build_resonance(d):
            m = tro.OverfitResonanceStack(n, device=d)
            m.load_state_dict(state)
            return m

        card_against_cpu(f"perceptual (a) overfit_resonance at {n} samples, "
                         f"get_one_audio_segment({n}, seed=9)", one_step_both(
            build_resonance, lambda m, d, dt: tro.ResonanceLoss(corpus.to(d, dt))(
                m(torch.from_numpy(noise[0]).to(d, dt))), dev),
            dev, tol["loss"], tol["gradients64"])
        target = torch.from_numpy(synthetic_audio(n, 22050, n_events=max(4, int(n / 22050 * 8)),
                                                  seed=9))
        peak_reset(dev)
        run = tro.overfit_resonance(iterations=c["steps"], tiny=c["tiny"], target=target,
                                    noise=lambda i: torch.from_numpy(noise[i]), device=dev,
                                    log=quiet)
        res_peak = peak_gib(dev)
        ms = host_step_ms(run.step_starts, run.t_end)
        n_params = sum(p.numel() for p in run.model.parameters())
        print(f"perceptual (a) overfit_resonance at {n} samples, 128 f0s (512 waves), depth 2, "
              f"4 mix channels ({n_params} parameters), lr 1e-3, mptpu's impulse noise: "
              f"{c['steps']} steps, {ms:.1f} ms a step (host clock, after the first); peak "
              f"memory {res_peak}")
        trajectory_check("perceptual (a) overfit_resonance", run.losses, ref["resonance"],
                         tol["trajectory"], falls(ref["resonance"]))
        adam = Adam(1e-3)
        st = adam.init(list(run.model.parameters()))
        loss_fn = tro.ResonanceLoss(target.reshape(1, 1, -1).to(dev))
        nz = torch.from_numpy(noise[0]).to(dev)
        traced_step("perceptual (a) overfit_resonance",
                    lambda: tro.resonance_step(run.model, adam, st, loss_fn, nz), ms, dev, sync)
        del run, loss_fn, adam, st

        # (b) the phase-invariance study
        c = cfg["phase"]
        peak_reset(dev)
        results = tpi.run_phaseinvariance(iterations=c["steps"], n_samples=c["n_samples"],
                                          out=os.path.join(tmp.name, "phase"), device=dev,
                                          log=quiet)
        pi_peak = peak_gib(dev)
        seg = torch.from_numpy(tpi.phaseinvariance_target(c["n_samples"])).reshape(1, 1, -1)
        transforms = tpi.transforms(dev)
        for name, r in results.items():
            pr = r["run"]
            ms = host_step_ms(pr.step_starts, pr.t_end)
            print(f"perceptual (b) run_phaseinvariance {name} at {c['n_samples']} samples, lr "
                  f"1e-2: {c['steps']} steps, {ms:.1f} ms a step (host clock, after the first; "
                  f"each step reads its loss for the NaN guard); loss {r['final_loss']:.6g} at "
                  f"step 0, {pr.step_losses[-1]:.6g} at the last; waveform SNR "
                  f"{r['snr_db']} dB, LSD {r['lsd_db']} dB")
            trajectory_check(f"perceptual (b) {name}", pr.step_losses, ref[f"phase_{name}"],
                             tol["phase_trajectory"], falls(ref[f"phase_{name}"]))
            x = pr.audio.clone().requires_grad_()
            transform, real = transforms[name], transforms[name](seg.to(dev))
            opt = torch.optim.Adam([x], lr=1e-2, betas=(0.9, 0.999))
            step = make_train_step(lambda: torch.mean((transform(x) - real) ** 2), opt)
            traced_step(f"perceptual (b) run_phaseinvariance {name}", step, ms, dev, sync)
            del x, real, opt
        wavs = [f for f in os.listdir(os.path.join(tmp.name, "phase")) if f.endswith(".wav")]
        print(f"perceptual (b) run_phaseinvariance: peak memory {pi_peak} over the three "
              f"transforms; metrics.json, report.html and {len(wavs)} WAVs written")
        del results

        # (c) texture synthesis, the texture and the scattering features
        for features, c in (("texture", cfg["texture"]), ("scattering", cfg["scattering"])):
            sizes = [c["tiny"]] + ([True] if c.get("reference_tiny") and not c["tiny"] else [])
            for tiny in sizes:
                n = 2**12 if tiny else 2**17
                tseg = torch.from_numpy(synthetic_audio(
                    n, 22050, n_events=max(4, int(n / 22050 * 8)), seed=5)).reshape(1, 1, -1)
                target = max_norm(tseg)
                init = torch.randn((1, 1, n), generator=torch.Generator().manual_seed(0)) * 0.01
                what = f"(c) synthesize_texture {features} at {n} samples"
                if features == "texture" or tiny:
                    def texture_of(m, d, dt, tiny=tiny, n=n, target=target):
                        tf = ttex.texture_featurizer(features, n, tiny, d)
                        return ttex.texture_loss(m.waveform, tf, tf(target.to(d, dt)))

                    card_against_cpu(f"perceptual {what}", one_step_both(
                        lambda d: Waveform(init).to(d), texture_of, dev),
                        dev, tol["loss"], tol["gradients64"])
                else:   # the CPU's float64 backward of the (64, 64, 2^17) scattering is slow:
                    # one float32 step's loss and gradient, card against CPU
                    host, host_grad = texture_gradient(features, n, tiny, init, target, cpu)
                    card, card_grad = texture_gradient(features, n, tiny, init, target, dev)
                    grad_err = share_err(card_grad, host_grad)
                    print(f"perceptual {what}, one float32 step on the card against the CPU "
                          f"from the same start: loss {card:.7g} against {host:.7g}; gradient "
                          f"max abs err over the largest {grad_err:.2e} (gate "
                          f"{tol['scattering_gradients32']:g})")
                    if grad_err > tol["scattering_gradients32"]:
                        fail(f"perceptual: {what}: the card's float32 gradient is {grad_err:.2e} "
                             f"off the CPU's")
                    del card_grad, host_grad
                peak_reset(dev)
                run = ttex.synthesize_texture(iterations=c["steps"], tiny=tiny, features=features,
                                              target=target, init=init,
                                              out=os.path.join(tmp.name, f"{features}{n}"),
                                              device=dev, log=quiet)
                tex_peak = peak_gib(dev)
                ms = host_step_ms(run.step_starts, run.t_end)
                print(f"perceptual {what}, {16 if tiny else 64} filters, lr 1e-3: {c['steps']} "
                      f"steps, {ms:.1f} ms a step (host clock, after the first); peak memory "
                      f"{tex_peak}")
                key = f"texture_{features}" + ("_tiny" if tiny else "")
                if key in ref:
                    trajectory_check(f"perceptual {what}", run.losses, ref[key],
                                     tol[f"{features}_trajectory" if features == "scattering"
                                         else "trajectory"], falls(ref[key]))
                else:
                    first = abs(run.losses[0] - host) / abs(host)
                    q = max(3, len(run.losses) // 4)
                    print(f"perceptual {what}: no mptpu trajectory at this size (its JAX-CPU run "
                          f"takes far longer than minutes); loss every step "
                          + ", ".join(f"{v:.7g}" for v in run.losses) + f"; the first "
                          f"{first:.2e} of the CPU's forward from the same start (gate "
                          f"{tol['loss']:g}); medians of the first and last {q}: "
                          f"{np.median(run.losses[:q]):.7g} -> "
                          f"{np.median(run.losses[-q:]):.7g} (gated on a fall, as mptpu's falls "
                          f"at --tiny)")
                    if not np.isfinite(run.losses).all() or first > tol["loss"]:
                        fail(f"perceptual: {what}: losses not finite or the first {first:.2e} "
                             f"off the CPU's")
                    if not falls(run.losses):
                        fail(f"perceptual: {what}: the loss did not fall")
                tf = ttex.texture_featurizer(features, n, tiny, dev)
                tfeat = tf(target.to(dev))
                x = run.params.clone().requires_grad_()
                adam = Adam(1e-3)
                st = adam.init([x])
                traced_step(f"perceptual {what}",
                            lambda: ttex.texture_step(x, adam, st, tf, tfeat), ms, dev, sync)
                del run, x, st, tf, tfeat

        # (d) the A5 modules that no script reaches, card against CPU in float64
        perceptual_modules_check(dev, tol["modules"])

        launches = dict(kernels.LAUNCHES)
        if any(launches.values()):
            fail(f"perceptual phase: launches {launches}, expected none")
        print(f"perceptual launches of the six kernels {launches} (none expected); the phase "
              f"took {time.perf_counter() - t_phase:.1f} s (host clock)")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        tmp.cleanup()


def texture_gradient(features, n, tiny, init, target, d, dtype=None):
    """``texture_loss`` at the waveform ``init`` against ``target``'s
    features, and its gradient by the waveform, on ``d`` in ``dtype``
    (default float32): (loss, gradient)."""
    import torch

    from mptpu_torch.models import texture as ttex

    dtype = dtype or torch.float32
    tf = ttex.texture_featurizer(features, n, tiny, d)
    x = init.to(d, dtype).requires_grad_()
    loss = ttex.texture_loss(x, tf, tf(target.to(d, dtype)))
    (grad,) = torch.autograd.grad(loss, [x])
    return float(loss.detach()), grad.detach()


def perceptual_modules_check(dev, tol):
    """Phase 12(d): each A5 module that no script reaches, and two of A6, at
    a small size, forward and the gradient of ``sum(out * cotangent)`` by
    its inputs and parameters, on the card against the CPU in float64
    (within ``tol`` of each tensor's largest; a tensor that is 0 in exact
    arithmetic, below 1e-12 of the case's largest, is not held). The info
    losses run at their init's scale: in float64 their codes are decided
    far beyond rounding (scores near 2e-4, top-two gaps down to 5.4e-9;
    the float32 tests widen the kernels 50-fold for that).
    ``MultiBandSpectralInfoLoss`` runs over two bands, 1024 and 2048 on
    2048 samples."""
    import torch

    from mptpu_torch.config import Experiment
    from mptpu_torch.gen.ddsp import HarmonicModel
    from mptpu_torch.gen.transfer import freq_domain_transfer_function_to_resonance
    from mptpu_torch.losses import (AutocorrelationLoss, CorrelationLoss,
                                    MultiBandSpectralInfoLoss, MultiWindowSpectralInfoLoss,
                                    SpectralInfoLoss, least_squares_disc_loss,
                                    least_squares_generator_loss, serial_loss)
    from mptpu_torch.ops.stft import stft
    from mptpu_torch.perceptual import (CochleaModel, MoreCorrectScattering,
                                        PsychoacousticFeature, mel_scale_hz)

    cpu = torch.device("cpu")
    gen = torch.Generator().manual_seed(0)

    def r(*shape, lo=None, hi=None):
        if lo is not None:
            return torch.rand(*shape, generator=gen, dtype=torch.float64) * (hi - lo) + lo
        return torch.randn(*shape, generator=gen, dtype=torch.float64)

    def exp(d):
        return Experiment(22050, 4096, model_dim=16, kernel_size=128, device=d)

    a, b = r(1, 1, 4096), r(1, 1, 4096)
    cases = {
        "Experiment.perceptual_feature": (lambda d: (exp(d).perceptual_feature, None), [a]),
        "Experiment.pooled_filter_bank": (lambda d: (exp(d).pooled_filter_bank, None), [a]),
        "Experiment.perceptual_triune": (lambda d: (lambda x: torch.cat(
            [v.reshape(-1) for v in exp(d).perceptual_triune(x)]), None), [a]),
        "Experiment.perceptual_loss l2": (lambda d: (exp(d).perceptual_loss, None), [a, b]),
        "Experiment.perceptual_loss l1": (lambda d: (lambda x, y: exp(d).perceptual_loss(
            x, y, "l1"), None), [a, b]),
        "CochleaModel": (lambda d: (CochleaModel(n_filters=16, kernel_size=128, device=d), None),
                         [r(2, 1, 1024)]),
        "PsychoacousticFeature.loss": (lambda d: (PsychoacousticFeature(
            n_bands=8, device=d).loss, None), [r(1, 1, 16384), r(1, 1, 16384)]),
        "MoreCorrectScattering": (lambda d: (MoreCorrectScattering(
            22050, mel_scale_hz(20, 11000, 6), 64, device=d), None), [r(1, 1, 1024)]),
    }
    noise, perm = r(1, 1024 * 16), torch.randperm(1024 * 16, generator=gen)
    cases["CorrelationLoss"] = (lambda d: (lambda x, y: CorrelationLoss(64)(
        x, y, noise=noise.to(d), indices=perm.to(d)), None), [a, b * 3])
    cases["serial_loss"] = (lambda d: (lambda x, y: serial_loss(
        y, x, lambda v: stft(v, 128, 64, pad=True)), None), [r(1, 1, 512), r(1, 3, 512)])
    cases["least_squares GAN losses"] = (lambda d: (lambda x, y: least_squares_disc_loss(x, y)
                                                    + least_squares_generator_loss(y), None),
                                         [r(4, 3), r(4, 3)])
    info = {"SpectralInfoLoss": lambda d: SpectralInfoLoss(256, 64, (8, 8), (4, 4),
                                                          n_centroids=32, device=d),
            "MultiWindowSpectralInfoLoss": lambda d: MultiWindowSpectralInfoLoss(
                (((16, 16), (8, 8)), ((8, 16), (4, 8))), device=d),
            "MultiBandSpectralInfoLoss": lambda d: MultiBandSpectralInfoLoss((1024, 2048),
                                                                             device=d)}
    for name, make in info.items():
        n = 8192 if name.startswith("MultiWindow") else 2048
        cases[name] = (lambda d, make=make: (lambda m: (m, m))(make(d)), [r(1, 1, n), r(1, 1, n)])
    cases["AutocorrelationLoss.multiband_loss"] = (lambda d: (AutocorrelationLoss(
        8, 64, device=d).multiband_loss, None), [r(2, 1, 2048), r(2, 1, 2048)])
    cases["freq_domain_transfer_function_to_resonance"] = (lambda d: (
        lambda c: freq_domain_transfer_function_to_resonance(64, c, 16), None),
        [r(2, 33, lo=0.5, hi=0.99)])
    hm = HarmonicModel(n_voices=4, n_profiles=8, n_harmonics=16, n_frames=16, n_samples=1024)
    cases["HarmonicModel"] = (lambda d: (hm, None), [r(8, 16, lo=0.0, hi=0.1), r(1, 128),
                                                     r(1, 512)])
    errs = {}
    for name, (build, inputs) in cases.items():
        outs = {}
        for d in (dev, cpu):
            fn, module = build(d)
            params = []
            if module is not None:
                module.double()
                params = list(module.parameters())
            xs = [x.to(d).requires_grad_() for x in inputs]
            out = fn(*xs)
            cot = torch.randn(out.shape, generator=torch.Generator().manual_seed(1),
                              dtype=torch.float64).to(d)
            grads = torch.autograd.grad(out, xs + params, cot, allow_unused=True,
                                        materialize_grads=True)
            outs[d.type] = [out.detach()] + list(grads)
        floor = 1e-12 * max(float(h.abs().max()) for h in outs["cpu"])
        errs[name] = max(share_err(x, h) if max(float(x.abs().max()), float(h.abs().max()))
                         >= floor else 0.0 for x, h in zip(outs[dev.type], outs["cpu"]))
    print("perceptual (d) the A5 modules, CorrelationLoss, serial_loss, the GAN and info losses, "
          "the multiband autocorrelation loss, the transfer function and the harmonic model, "
          "card against CPU in float64, forward and gradients, max abs err over the largest: "
          + "; ".join(f"{k} {v:.1e}" for k, v in errs.items()) + f" (gate {tol:g})")
    worst = max(errs, key=errs.get)
    if errs[worst] > tol:
        fail(f"perceptual: {worst} is {errs[worst]:.2e} off the CPU in float64")


def zoo_phase(dev, cfg, sync):
    """Phase 13, the rest of the gen/ zoo, the energy-instrument overfit and
    the two trainers (ROADMAP A9a), launch counts set to 0 first and read
    last: (a) ``overfit_energy`` at scripts/energy_overfit.py's defaults,
    after one step on the card against the CPU from the same parameters and
    target (``get_one_audio_segment(2**15, seed=5)`` off the demo corpus
    under a temporary MPTPU_CACHE), its trajectory held to ``mptpu``'s
    (tests/reference/energy_trajectory.py, on its synthetic target), ms a
    step, a traced step; (b) each generator of the zoo at the widths of
    ``ZOO``'s comment: a float32 forward on the card against the CPU, a
    float64 forward and gradient on the card against the CPU, ms and
    launches of one forward (the two per-sample loops, ``goo.simulate`` and
    ``waveguide_synth_scan``, timed apart, their launches traced over their
    first ``scan_trace`` steps); (c) ``make_gan_steps`` with the splat
    overfit's generator and ``DownsamplingDiscriminator``, one step each in
    float64 on the card against the CPU, and ``BaseExperimentRunner``
    driving (a)'s step over a stream with checkpoints, then ``resume``;
    none of the six kernels launched."""
    import os
    import tempfile

    import torch

    from mptpu_torch import kernels
    from mptpu_torch.data import get_one_audio_segment
    from mptpu_torch.data.synthetic import synthetic_audio
    from mptpu_torch.models import energy_overfit as teo
    from mptpu_torch.train.optim import Adam

    cpu = torch.device("cpu")
    tol = dict(ZOO_TOL, **cfg.get("tol", {}))
    c = cfg["energy"]
    n, block, channels, layers = teo.TINY if c["tiny"] else teo.FULL
    tmp = tempfile.TemporaryDirectory()
    saved = {k: os.environ.get(k) for k in ("MPTPU_CACHE", "AUDIO_PATH")}
    os.environ.pop("AUDIO_PATH", None)
    os.environ["MPTPU_CACHE"] = tmp.name
    try:
        kernels.reset_launches()
        t_phase = time.perf_counter()

        # (a) the energy overfit
        corpus = get_one_audio_segment(n, 22050, seed=5, device=cpu)
        card_against_cpu(f"zoo (a) overfit_energy at {n} samples, get_one_audio_segment({n}, "
                         f"seed=5)", one_step_both(
            lambda d: teo.EnergyOverfit(n, block, channels, layers, device=d),
            lambda m, d, dt: teo.EnergyLoss(corpus.to(d, dt), block)(m())[0], dev),
            dev, tol["loss"], tol["gradients64"])
        target = torch.from_numpy(synthetic_audio(n, 22050, n_events=max(4, int(n / 22050 * 8)),
                                                  seed=5))
        peak_reset(dev)
        run = teo.overfit_energy(iterations=c["steps"], tiny=c["tiny"], target=target, device=dev,
                                 log=lambda s: None)
        peak = peak_gib(dev)
        ms = host_step_ms(run.step_starts, run.t_end)
        n_params = sum(p.numel() for p in run.state.parameters())
        print(f"zoo (a) overfit_energy at {n} samples, block {block}, {channels} channels, "
              f"{layers} layers ({n_params} parameters), lr 1e-3: {c['steps']} steps, {ms:.2f} ms "
              f"a step (host clock, after the first); peak memory {peak}")
        ref, k = cfg["reference"], min(tol["trajectory_steps"], len(cfg["reference"]))
        scale = float(np.abs(ref).max())
        trajectory_check(f"zoo (a) overfit_energy, its first {k} steps", run.losses[:k], ref[:k],
                         tol["trajectory"], False, scale=scale)
        trajectory_check(f"zoo (a) overfit_energy, all {len(ref)} steps", run.losses, ref,
                         tol["spread"], falls(ref), scale=scale)
        # the frozen control: the untrained instrument on the same fixed target has the run's
        # first loss at every step; the gate on all the steps must be one that it fails
        control = float(np.abs(run.losses[0] - np.asarray(ref, np.float64)).max()) / scale
        print(f"zoo (a) overfit_energy, the frozen control (the untrained instrument, loss "
              f"{run.losses[0]:.7g} every step): mptpu's trajectory {control:.2e} of its largest "
              f"loss away at most (the gate on all {len(ref)} steps {tol['spread']:g} must stand "
              f"below it)")
        if len(ref) > k and not control > tol["spread"]:
            fail(f"zoo (a) overfit_energy: the frozen control stands {control:.2e} from mptpu's "
                 f"trajectory, within the gate {tol['spread']:g} that should tell it from training")
        adam = Adam(1e-3)
        st = adam.init(run.state.leaves())
        loss_fn = teo.EnergyLoss(target.reshape(1, 1, -1).to(dev), block)
        traced_step("zoo (a) overfit_energy",
                    lambda: teo.energy_step(run.state, adam, st, loss_fn), ms, dev, sync)

        # (b) the generators
        for case in zoo_cases(cfg):
            zoo_case(dev, case, tol, sync, cfg)

        # (c) the trainers
        gan_check(dev, cfg, tol["gan"])
        runner_check(dev, cfg, target, tmp.name)

        launches = dict(kernels.LAUNCHES)
        if any(launches.values()):
            fail(f"zoo phase: launches {launches}, expected none")
        print(f"zoo launches of the six kernels {launches} (none expected); the phase took "
              f"{time.perf_counter() - t_phase:.1f} s (host clock)")
    finally:
        for key, v in saved.items():
            if v is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = v
        tmp.cleanup()


class _Call:
    """A zoo case's module with the call that renders it: ``call(module,
    *inputs)``."""

    def __init__(self, module, call):
        self.module, self.call = module, call

    def __call__(self, *inputs):
        return self.call(self.module, *inputs)


def zoo_cases(cfg):
    """The generators of phase 13(b): (name, build(device) -> module,
    call(module, *inputs), numpy inputs, indices of the inputs to
    differentiate, float32 gate kind, whether the gradient is held, the
    per-sample steps of a loop traced apart or 0)."""
    import torch

    from mptpu_torch.gen import (audiomodel, convimpulse, event_variants, goo, instrument,
                                 lookups, physical, recurrent, reds_model, waveguide)
    from mptpu_torch.gen.transfer import make_waves
    from mptpu_torch.utils.music import musical_scale_hz

    n, sn, sf, ctx, items = (cfg["n"], cfg["siam_n"], cfg["siam_frames"], cfg["context"],
                             cfg["items"])
    rng = np.random.default_rng(13)

    def r(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    def u(*shape):
        return rng.uniform(-1.0, 1.0, shape).astype(np.float32)

    class Nothing(torch.nn.Module):
        pass

    cases = []
    add = lambda *a: cases.append(a)   # noqa: E731
    # row 5: the spring mesh
    add("goo.simulate (string_mesh(32), pluck_forces at mass 8)", lambda d: Nothing(),
        lambda m, f: goo.simulate(goo.string_mesh(32, dtype=f.dtype, device=f.device), f),
        [goo.pluck_forces(n, 32, position=8, device="cpu").numpy()], (), "forward32", False, n)
    # row 6: the waveguides
    add("WaveguideSynth(512 delays)", lambda d: waveguide.WaveguideSynth(512, n, device=d),
        lambda m, imp, sel, damp, filt, nz: m(imp, sel, damp, filt, noise=nz),
        [r(1, 64), r(1, 512, 32), r(1, 1), r(1, 128), u(1, 1, n)], (0, 1, 2, 3), "forward32",
        True, 0)
    imp = np.zeros(n, np.float32)
    imp[:256] = r(256)
    add("waveguide_synth_scan", lambda d: Nothing(),
        lambda m, i, de, da, fs: waveguide.waveguide_synth_scan(i, de, da, fs),
        [imp, rng.integers(50, 400, n).astype(np.float32), rng.uniform(0.9, 0.99, n)
         .astype(np.float32), rng.integers(1, 33, n).astype(np.float32)], (0, 2), "forward32",
        True, n)
    # row 7
    for cumulative in (False, True):
        add(f"TransferFunctionSegmentGenerator(16, 128 frames, window 512, cumulative="
            f"{cumulative})", lambda d, c=cumulative: physical.TransferFunctionSegmentGenerator(
                16, n // 256, 512, n, cumulative=c, device=d),
            lambda m, x, nz: m(x, noise=nz), [r(1, 16), u(1, 1, n)], (0,), "forward32", True, 0)
    # row 8 and 9: running sums of phase
    add("RecurrentSynth(2 layers, 16 channels, 16 frames)", lambda d: recurrent.RecurrentSynth(
        2, 16, n // 16, 16, device=d), lambda m, x, nz: m(x, noise=nz), [r(1, 16), u(1, n)], (0,),
        "phase32", True, 0)
    add("AudioModel(model 16, 64 frames, 128 noise frames)", lambda d: audiomodel.AudioModel(
        n, 16, 22050, 64, 128, device=d), lambda m, x, nz: m(x, noise=nz),
        [r(1, 16, 64, scale=0.5), u(1, n)], (0,), "phase32", True, 0)
    # row 10
    add("InstrumentStack(encoding 32, 16 channels, 128 frames, shape 8, 2 layers)",
        lambda d: instrument.InstrumentStack(32, 16, n // 256, n, 8, 2, device=d),
        lambda m, e, t0, t1, d0, d1, mx: m(e, [t0, t1], [d0, d1], mx),
        [np.abs(r(1, 1, 16, n // 256)), r(1, 1, 8, 16), r(1, 1, 8, 16), r(1, 1, 1), r(1, 1, 1),
         r(1, 1, 2)], (0, 1, 3, 5), "forward32", True, 0)
    # row 11: the lookups at SIAM's decoder widths
    sel = lambda: np.maximum(r(1, 1, items), 0)   # noqa: E731
    add(f"SampleResonanceLookup({items} items of {cfg['sample_items_len']})",
        lambda d: lookups.SampleResonanceLookup(items, cfg["sample_items_len"], device=d),
        lambda m, s: m(s), [sel()], (0,), "forward32", True, 0)
    add(f"FFTResonanceLookup({items} items, window 2048, {sn} samples)",
        lambda d: lookups.FFTResonanceLookup(items, sn, device=d), lambda m, s: m(s), [sel()],
        (0,), "frame_sum32", True, 0)
    add(f"WavetableLookup({items} items, {items} waves of 16384)",
        lambda d: lookups.WavetableLookup(items, items, device=d), lambda m, s: m(s),
        [r(1, 1, items)], (0,), "forward32", True, 0)
    add(f"MultibandResonanceLookup({items} items, out 16384)",
        lambda d: lookups.MultibandResonanceLookup(items, 0, device=d), lambda m, s: m(s),
        [sel()], (0,), "frame_sum32", True, 0)
    add(f"MultiSSM(control 32, {sf} frames, state 128, window {2 * sn // sf}, {items} planes)",
        lambda d: lookups.MultiSSM(ctx, 32, sf, 128, 2 * sn // sf, 1, items, sn, device=d),
        lambda m, ch, t: m(ch, t), [r(1, 1, items), r(1, 1, sf, scale=0.02)], (0, 1),
        "forward32", True, 0)
    # row 12
    add(f"AudioModelEventGenerator({items} items, {sn} samples, {sf} frames)",
        lambda d: event_variants.AudioModelEventGenerator(items, sn, sf, 1, ctx, device=d),
        lambda m, p, t, a, nz: m(p, t, a, noise=nz),
        [r(1, 1, items), r(1, 1, sf, scale=0.02), r(1, 1, 1), u(1, sf, sn // sf + 1)], (0, 2),
        "frame_sum32", True, 0)
    wt_spec = dict(amplitudes=(1,), mix=(8, items * 5), warp=(128,), room_choice=(8,),
                   room_mix=(2,))
    add(f"WavetableModel({items} items, {sn} samples, expressivity 8)",
        lambda d: event_variants.WavetableModel(items, sn, sf, 1, 8, device=d),
        lambda m, *a: m(dict(zip(wt_spec, a[:-1])), a[-1]),
        [r(1, 1, *s, scale=0.1) for s in wt_spec.values()] + [r(1, 1, sf, scale=0.02)],
        (0, 1, 2, 3, 4), "forward32", True, 0)
    add(f"SimpleEventGenerator(context {ctx}, {sf} frames, {sn} samples, 128 channels)",
        lambda d: event_variants.SimpleEventGenerator(ctx, sf, sn, 1, 128, device=d),
        lambda m, p, t, nz: m(p, t, noise=nz),
        [r(1, 1, ctx), r(1, 1, sf, scale=0.02), u(1, sf, 257, 1)], (0,), "frame_sum32", True, 0)
    # rows 13 and 14 share one table of items // 4 musical f0s at n samples, which scipy takes
    # seconds to build: built once here, on the host, and copied to each case's device
    table = make_waves(n, musical_scale_hz(21, 106, items // 4).tolist(), 22050, device="cpu")
    # row 13
    add(f"ConvImpulseEventGenerator(context {ctx}, impulse 4096, resonance {n}, {sn} samples, "
        f"{items} atoms)", lambda d: convimpulse.ConvImpulseEventGenerator(
            ctx, min(4096, n), n, 22050, sn, total_atoms=items, waves=table.to(d), device=d),
        lambda m, v, t, nz: m(v, t, noise=nz),
        [r(1, 1, ctx), np.abs(r(1, 1, sn // 256)), u(1, min(4096, n))], (0,), "forward32", True,
        0, ("ResonanceChain_0.Dense_0",))   # the chain's depth mix, scaled out by a unit norm
    # row 14
    for wavetables in (False, True):
        spec = reds_model.RedsLikeModel(n_samples=256, device="cpu").shape_spec
        if wavetables:
            spec = dict(spec, f0_choice=(items,))
        add(f"RedsLikeModel({f'{items} wavetables' if wavetables else '64 octaves'}, "
            f"{cfg['reds_atoms']} atoms)", lambda d, w=wavetables: reds_model.RedsLikeModel(
                n_samples=n, use_wavetables=w, n_wavetable_resonances=items,
                waves=table.to(d) if w else None, device=d),
            lambda m, *a, s=spec: m(dict(zip(s, a[:-1])), noise=a[-1]),
            [r(1, cfg["reds_atoms"], *s, scale=0.5) for s in spec.values()] + [u(1, 1, n)],
            tuple(range(len(spec))), "frame_sum32", True, 0)
    return cases


def zoo_case(dev, case, tol, sync, cfg):
    """One generator of phase 13(b): the card against the CPU from the same
    parameters and inputs, float32 forward (of its peak) and float64
    forward and gradient of ``sum(out * cotangent)`` by the parameters and
    the inputs ``wrt`` (of each tensor's largest), then ms and launches of
    one float32 forward on the card."""
    import torch

    name, build, call, arrays, wrt, kind, with_grad, loop, *rest = case
    scale_free = rest[0] if rest else ()
    cpu = torch.device("cpu")
    host = build(cpu)
    card = build(dev)
    card.load_state_dict(host.state_dict())

    # a per-sample loop is held card against CPU over its first scan_compare steps
    held = [a[:cfg["scan_compare"]] for a in arrays] if loop else arrays

    def inputs(d, dtype, grad, arrays=held):
        return [torch.tensor(a, device=d, dtype=dtype if a.dtype.kind == "f" else None,
                             requires_grad=grad and i in wrt) for i, a in enumerate(arrays)]

    def forward(m, d, dtype, grad):
        m.to(dtype)
        ins = inputs(d, dtype, grad)
        with torch.set_grad_enabled(grad):
            out = call(m, *ins)
        if not grad:
            return out.detach(), {}
        cot = torch.from_numpy(np.random.default_rng(7).standard_normal(tuple(out.shape))).to(
            d, dtype)
        names, params = zip(*m.named_parameters()) if len(list(m.parameters())) else ((), ())
        grads = torch.autograd.grad(torch.sum(out * cot), list(params) + [ins[i] for i in wrt],
                                    allow_unused=True, materialize_grads=True)
        return out.detach(), dict(zip(list(names) + [f"input {i}" for i in wrt],
                                      [g.detach() for g in grads]))

    t0 = time.perf_counter()
    out_c, _ = forward(card, dev, torch.float32, False)
    out_h, _ = forward(host, cpu, torch.float32, False)
    e32 = share_err(out_c, out_h)
    out_c, g_c = forward(card, dev, torch.float64, with_grad)
    out_h, g_h = forward(host, cpu, torch.float64, with_grad)
    e64 = share_err(out_c, out_h)
    # a gradient that is 0 in exact arithmetic (a scale that a unit norm divides out) is held
    # against the case's largest gradient, not its own rounding
    largest = max([float(g.abs().max()) for g in g_h.values()], default=0.0)
    g64 = max([float((g_c[k].cpu() - g_h[k]).abs().max()) / largest
               if k.startswith(scale_free) else share_err(g_c[k], g_h[k])
               for k in g_h if float(g_h[k].abs().max()) > 0], default=0.0)
    del out_c, out_h, g_c, g_h
    card.to(torch.float32)
    ins = inputs(dev, torch.float32, False, arrays)
    with torch.no_grad():
        if loop:
            _, dev_ms, host_ms = timed(lambda: call(card, *ins), 1, dev, warmup=False, host=True)
            short = [a[:cfg["scan_trace"]] for a in ins]
            _, _, short_ms = timed(lambda: call(card, *short), 1, dev, host=True)
            traced = (device_time_by_kernel(lambda: call(card, *short), sync)
                      if dev.type == "cuda" else None)
            k = cfg["scan_trace"]
            launches = (f"{traced[2] * loop // k} (traced over its first {k} steps, "
                        f"{traced[2]}, times {loop // k})" if traced else "not measured (no card)")
        else:
            _, dev_ms, host_ms = timed(lambda: call(card, *ins), 3, dev, host=True)
            traced = (device_time_by_kernel(lambda: call(card, *ins), sync)
                      if dev.type == "cuda" else None)
            launches = traced[2] if traced else "not measured (no card)"
    gate = tol[kind]
    gate64 = tol["phase64"] if kind == "phase32" else tol["gradients64"]
    print(f"zoo (b) {name}: card against CPU"
          + (f" over the first {cfg['scan_compare']} steps" if loop else "")
          + f", float32 forward {e32:.2e} of its peak (gate "
          f"{gate:g}), float64 forward {e64:.2e}"
          + (f", float64 gradients {g64:.2e}" if with_grad else ", no gradient held")
          + f" (gate {gate64:g}); one forward {ms_text(dev_ms, host_ms)}, "
          f"{launches} launches; the case took {time.perf_counter() - t0:.1f} s")
    if traced and traced[0]:
        print(busy_line(f"zoo (b) {name}, one forward" + (f" of its first {cfg['scan_trace']} "
                                                          f"steps" if loop else "") + " traced",
                        traced, short_ms if loop else host_ms))
    if not e32 <= gate or not e64 <= gate64 or not g64 <= gate64:
        fail(f"zoo (b) {name}: the card is off the CPU (float32 {e32:.2e}, float64 {e64:.2e}, "
             f"gradients {g64:.2e})")
    del host, card


def gan_steps(devices, n, threads=None):
    """One generator step and one discriminator step of ``make_gan_steps``
    (the splat overfit's generator, 2 events, context 8;
    ``DownsamplingDiscriminator``, window 256, step 128, 16 channels; Adam
    lr 1e-4) in float64 at ``n`` samples on each device, from one seed:
    {device type: (losses, new parameters, Adam's first moments)}, names
    prefixed by their player. ``threads`` sets the CPU's threads for the
    run."""
    import torch
    from torch.func import functional_call

    from mptpu_torch.models import OverfitHierarchicalEvents
    from mptpu_torch.nn.unet import DownsamplingDiscriminator
    from mptpu_torch.train import Adam, make_gan_steps

    rng = np.random.default_rng(6)
    batch = (rng.standard_normal((1, 1, n)) * 0.1)
    noise = rng.uniform(-1, 1, (1, 1, n))
    saved = torch.get_num_threads()
    if threads:
        torch.set_num_threads(threads)
    results = {}
    try:
        for d in devices:
            gen = OverfitHierarchicalEvents(n, 22050, 2, 8, device=d).double()
            disc = DownsamplingDiscriminator(256, 128, n, 16, device=d).double()

            def gen_apply(p, b, key, gen=gen):
                rendered, _, _ = functional_call(gen, p, (), dict(noise=key))
                return torch.sum(rendered, dim=1, keepdim=True)

            def disc_apply(p, x, disc=disc):
                return functional_call(disc, p, (x,))

            train_gen, train_disc = make_gan_steps(gen_apply, disc_apply, Adam(1e-4), Adam(1e-4))
            gp, dp = dict(gen.named_parameters()), dict(disc.named_parameters())
            b, nz = torch.from_numpy(batch).to(d), torch.from_numpy(noise).to(d)
            gp2, gs, gl = train_gen(gp, Adam(1e-4).init(list(gp.values())), dp, b, nz)
            dp2, ds, dl = train_disc(dp, Adam(1e-4).init(list(dp.values())), gp, b, nz)
            names = [f"gen {k}" for k in gp2] + [f"disc {k}" for k in dp2]
            results[d.type] = ([gl, dl], dict(zip(names, list(gp2.values()) + list(dp2.values()))),
                               dict(zip(names, gs.mu + ds.mu)))
    finally:
        torch.set_num_threads(saved)
    return results


def moment_errs(mc, mh, held):
    """Each first moment's largest difference over its player's largest
    first moment (``gen`` or ``disc``)."""
    largest = {p: max(float(mh[k].abs().max()) for k in held if k.startswith(p))
               for p in ("gen", "disc")}
    return {k: float((mc[k].cpu() - mh[k]).abs().max()) / largest[k.split()[0]] for k in held}


def gan_check(dev, cfg, gate):
    """Phase 13(c): ``gan_steps`` at ``gan_n`` in float64, the card against
    the CPU: losses, new parameters (of each tensor's largest) and Adam's
    first moments (of each player's largest). The generator's ``times`` is
    printed beside the CPU's own spread on 1 thread against all, and not
    held: some levels of its binary-tree dirac take FFT round-off for their
    gradient."""
    import torch

    cpu = torch.device("cpu")
    n = cfg["gan_n"]
    results = gan_steps((dev, cpu), n)
    (lc, pc, mc), (lh, ph, mh) = results[dev.type], results["cpu"]
    held = [k for k in mh if k != "gen times" and float(mh[k].abs().max()) > 0]
    loss = max(abs(float(a) - float(b)) / abs(float(b)) for a, b in zip(lc, lh))
    params = max(share_err(pc[k], ph[k]) for k in held)
    errs = moment_errs(mc, mh, held)
    moments = max(errs.values())
    worst = sorted(errs, key=errs.get)[-3:]
    times = moment_errs(mc, mh, held + ["gen times"])["gen times"]
    one = gan_steps((cpu,), n, threads=1)["cpu"][2]
    witness = moment_errs(one, mh, held + ["gen times"])["gen times"]
    print("zoo (c) make_gan_steps, the first moments farthest from the CPU's, of their player's "
          "largest: " + ", ".join(f"{k} {errs[k]:.2e} (its own largest "
                                  f"{float(mh[k].abs().max()):.2e}, {share_err(mc[k], mh[k]):.2e} "
                                  f"of it)" for k in reversed(worst)))
    print(f"zoo (c) make_gan_steps at {n} samples (OverfitHierarchicalEvents, 2 events; "
          f"DownsamplingDiscriminator): generator loss {float(lc[0]):.9g}, discriminator loss "
          f"{float(lc[1]):.9g}; float64 card against CPU: losses {loss:.2e}, new parameters "
          f"{params:.2e}, first moments {moments:.2e} of their player's largest (gate {gate:g}); "
          f"the times' first moment {times:.2e} of the generator's largest, not held: the CPU on "
          f"1 thread against all stands {witness:.2e} off")
    if not max(loss, params, moments) <= gate:
        fail(f"zoo (c) make_gan_steps: the card is off the CPU ({loss:.2e}, {params:.2e}, "
             f"{moments:.2e})")


def runner_check(dev, cfg, target, tmp):
    """Phase 13(c): ``BaseExperimentRunner`` driving (a)'s step over a
    stream of the target, with ``real`` and ``fake`` logged to a collection
    and a checkpoint every other iteration into a temporary directory; then
    a new runner's ``resume`` must give back the newest checkpoint's step,
    parameters and Adam state, bit for bit."""
    import os

    import torch

    from mptpu_torch.models import energy_overfit as teo
    from mptpu_torch.obs.collection import Collection
    from mptpu_torch.train import Adam, BaseExperimentRunner

    c = cfg["energy"]
    n, block, channels, layers = teo.TINY if c["tiny"] else teo.FULL
    state = teo.EnergyOverfit(n, block, channels, layers, device=dev)
    adam = Adam(1e-3)
    seg = target.reshape(1, 1, -1).to(dev)

    def train_step(params, opt, batch, key):
        loss, _, _, opt = teo.energy_step(state, adam, opt, teo.EnergyLoss(batch, block))
        with torch.no_grad():
            recon = state()
        return {k: v.detach().clone() for k, v in state.named_parameters()}, opt, loss, recon

    steps = c["runner_steps"]
    ckpt = os.path.join(tmp, "runner")
    t0 = time.perf_counter()
    run = BaseExperimentRunner((seg for _ in range(steps)), train_step,
                               dict(state.named_parameters()), adam.init(state.leaves()),
                               checkpoint_dir=ckpt, checkpoint_every=2,
                               collection=Collection(os.path.join(tmp, "runner_kv")), device=dev)
    run.run()
    ms = 1e3 * (time.perf_counter() - t0) / steps
    again = BaseExperimentRunner([], train_step, None, None, checkpoint_dir=ckpt, device=dev)
    step = again.resume()
    last = (steps - 1) // 2 * 2
    same = (step == last and set(again.params) == set(run.params)
            and all(torch.equal(again.params[k], run.params[k]) for k in run.params)
            and int(again.opt_state.count) == steps
            and all(torch.equal(a, b) for a, b in zip(again.opt_state.mu, run.opt_state.mu)))
    print(f"zoo (c) BaseExperimentRunner: {steps} steps of (a)'s step over a stream, "
          f"{ms:.1f} ms a step (host clock, each reading its loss), losses "
          + ", ".join(f"{v:.7g}" for v in run.losses)
          + f"; checkpoints {sorted(os.listdir(ckpt))}; resume gave step {step} (expected "
          f"{last}) and {'the same' if same else 'OTHER'} parameters and Adam state")
    if not same or not np.isfinite(run.losses).all():
        fail("zoo (c) BaseExperimentRunner: resume did not give back the last checkpoint")


class _DictInput:
    """An ``EncoderShell`` called with its two bands' features as
    arguments (so that the check above can move them and take their
    gradients)."""

    def __init__(self, shell):
        self.shell = shell

    def __getattr__(self, name):
        return getattr(self.shell, name)

    def __call__(self, a, b):
        return self.shell({512: a, 1024: b})


def run(dev, cfg, peaks, sync, mb=MULTIBAND, splat=SPLAT, siam=SIAM, ssm=SSM,
        siam_train=SIAM_TRAIN, models=MODELS, longtail=LONGTAIL, perceptual=PERCEPTUAL, zoo=ZOO):
    """Phases 2-13 on device ``dev``; returns the kernels' records."""
    import torch
    import torch.nn.functional as F

    from mptpu_torch import kernels
    from mptpu_torch.ops import unit_norm
    from mptpu_torch.sparse import (
        boundary_update_plain, cuda_boundary_update, cuda_fused_encode, cuda_fused_encode_lane,
        cuda_fused_step, cuda_fused_step_pipelined, dictionary_gram, encode_state, fast_geometry,
        fused_encode_lane_plain, fused_encode_plain, fused_step_plain, reconstruct_from_events,
        sparse_code, sparse_code_fast,
    )
    from mptpu_torch.sparse.cuda_fused_mp import (
        cluster_size, encode_cluster_size, encode_plan, step_plan,
    )
    from mptpu_torch.device import no_tf32
    from mptpu_torch.probes import probe_launches, probe_plain

    B, N, A, n = cfg["batch"], cfg["n_atoms"], cfg["atom_size"], cfg["n_samples"]
    S, block = cfg["n_steps"], cfg["block"]
    geom = fast_geometry(n, A, block)
    kw = geom._asdict()
    records = {}

    # ---- phase 2: kernels against their plain versions on the planted signal
    d_np, sig_np = planted_signal(cfg)
    d_pl = torch.from_numpy(d_np).to(dev)
    sig_pl = torch.from_numpy(sig_np).to(dev)
    d2 = unit_norm(d_pl)
    gram_p = F.pad(dictionary_gram(d2), (0, 1))
    fm0, bm0, res0 = encode_state(sig_pl, d2, geom)
    bm0_pad = F.pad(bm0, (0, geom.nb_pad - geom.n_blocks), value=-3e38)
    tail_idx = (n - A + torch.arange(A, device=dev))[:, None] + torch.arange(A, device=dev)
    windows = res0[:, tail_idx].contiguous()

    fk, bk = fm0.clone(), bm0.clone()
    fp, bp = fm0.clone(), bm0.clone()
    cuda_boundary_update(fk, bk, windows, d2, geom.tail_start, block)
    boundary_update_plain(fp, bp, windows, d2, geom.tail_start, block)
    sync()
    ts, te = geom.tail_start, geom.tail_start + A
    assert_close("boundary tail", fk[:, :, ts:te], fp[:, :, ts:te], TAIL_TOL)
    assert_close("boundary tmax", bk, bp, TAIL_TOL)
    if not (torch.equal(fk[:, :, :ts], fm0[:, :, :ts]) and torch.equal(fk[:, :, te:], fm0[:, :, te:])):
        fail("boundary kernel wrote outside the tail")
    records["cuda_boundary_update"] = dict(max_abs_err=max_err([(fk, fp), (bk, bp)]))
    print(f"check cuda_boundary_update vs plain: tail max abs err "
          f"{records['cuda_boundary_update']['max_abs_err']:.3e} (tol {TAIL_TOL})")
    del fk, bk, fp, bp

    states = [(fm0.clone(), bm0.clone(), res0.clone()) for _ in range(2)]
    ek = cuda_fused_step(*states[0], d2, gram_p, **kw)
    ep = fused_step_plain(*states[1], d2, gram_p, **kw)
    sync()
    clipped1 = int((ep.positions > n - A).sum())
    if clipped1 == 0:
        fail("the one-step check has no clipped event")
    assert_events("fused step", ek, ep)
    if not torch.equal(ek.values, ep.values):
        fail("fused step: values are not bit-identical")
    for name, i in (("fm", 0), ("bm", 1)):
        assert_close(f"fused step {name}", states[0][i], states[1][i], TAIL_TOL)
    assert_close("fused step residual", states[0][2], states[1][2], RESIDUAL_TOL)
    records["cuda_fused_step"] = dict(max_abs_err=max_err(zip(states[0], states[1])))
    print(f"check cuda_fused_step vs plain, 1 step ({clipped1}/{B} clipped): events equal, "
          f"max abs err {records['cuda_fused_step']['max_abs_err']:.3e}")
    del states

    worst = 0.0
    for items, gate in ((B, True), (B, False), (min(3, B), True), (min(3, B), False), (1, True),
                        (1, False)):
        err, n_clip = cluster_step_check(
            f"cluster step, {items} items", (fm0[:items], bm0_pad[:items], res0[:items]),
            d2, gram_p, kw, 4, sync, gate_tail=gate,
        )
        worst = max(worst, err)
        print(f"check cuda_fused_step_pipelined vs cuda_fused_step and plain, {items} items x 4 "
              f"steps (gate_tail={gate}, {n_clip} clipped): clusters of 1 to 16, step by step "
              f"and as chains with and without programmatic serialization, and the one-block "
              f"kernel's chain: bit-identical to the one-block kernel step by step, max abs err "
              f"vs plain {err:.3e}")
    # the same at 2,048-tap atoms (a tenth of the amplitude, so that the
    # rounding of 2,048-term tail sums stays inside the tail tolerance)
    lgeom = fast_geometry(LONG_ATOMS["n_samples"], LONG_ATOMS["atom_size"], LONG_ATOMS["block"])
    ld_np, lsig_np = planted_signal(LONG_ATOMS)
    ld2 = unit_norm(torch.from_numpy(ld_np).to(dev))
    lfm, lbm, lres = encode_state(torch.from_numpy(0.1 * lsig_np).to(dev), ld2, lgeom)
    lbm = F.pad(lbm, (0, lgeom.nb_pad - lgeom.n_blocks), value=-3e38)
    err, n_clip = cluster_step_check(
        "cluster step, 2,048-tap atoms", (lfm, lbm, lres), ld2,
        F.pad(dictionary_gram(ld2), (0, 1)), lgeom._asdict(), LONG_ATOMS["n_steps"], sync)
    if n_clip == 0:
        fail("the 2,048-tap check has no clipped event")
    worst = max(worst, err)
    print(f"check the step kernels at {LONG_ATOMS['n_atoms']} atoms x {LONG_ATOMS['atom_size']} "
          f"taps, {LONG_ATOMS['batch']} items x {LONG_ATOMS['n_steps']} steps ({n_clip} clipped): "
          f"as above, max abs err vs plain {err:.3e}")
    del lfm, lbm, lres
    # the same at the learning path's geometry: dictionary_learning_step
    # encodes at its own block (512 at 512 taps, four 128-float chunks a block)
    lgeom = fast_geometry(n, A, learning_block(A))
    lfm, lbm, lres = encode_state(sig_pl, d2, lgeom)
    lbm = F.pad(lbm, (0, lgeom.nb_pad - lgeom.n_blocks), value=-3e38)
    err, n_clip = cluster_step_check(f"cluster step, block {lgeom.block}", (lfm, lbm, lres), d2,
                                     gram_p, lgeom._asdict(), 4, sync)
    worst = max(worst, err)
    print(f"check the step kernels at the learning path's block {lgeom.block}, {B} items x 4 "
          f"steps ({n_clip} clipped, map {tuple(lfm.shape)}): as above, max abs err vs plain "
          f"{err:.3e}")
    del lfm, lbm, lres
    records["cuda_fused_step_pipelined"] = dict(max_abs_err=worst)

    states = [(fm0.clone(), bm0_pad.clone(), res0.clone()) for _ in range(2)]
    ek = cuda_fused_encode(*states[0], d2, gram_p, n_steps=S, **kw)
    ep = fused_encode_plain(*states[1], d2, gram_p, n_steps=S, **kw)
    sync()
    assert_events("fused encode", ek, ep)
    assert_close("fused encode residual", states[0][2], states[1][2], RESIDUAL_TOL)
    assert_close("fused encode fm", states[0][0], states[1][0], TAIL_TOL)
    assert_close("fused encode bm", states[0][1], states[1][1], TAIL_TOL)
    records["cuda_fused_encode"] = dict(
        max_abs_err=max_err([*zip(states[0], states[1]), (ek.values, ep.values)])
    )
    print(f"check cuda_fused_encode vs plain, {S} steps "
          f"({int((ep.positions > n - A).sum())} clipped events): events equal, max abs err "
          f"{records['cuda_fused_encode']['max_abs_err']:.3e}")
    # the whole-encode kernel at every cluster size the card admits, a few
    # items and steps, with and without the tail gate: bit for bit the
    # one-block step kernel looped, and the plain version within the tail
    # tolerance
    on_card = dev.type == "cuda"   # CPU tensors take the plain versions: no launches
    few, few_steps = min(3, B), min(10, S)
    shapes = (N, A, block, geom.n_blocks, geom.upd_blocks)
    sizes = [c for c in (1, 2, 4, 8) if N % c == 0]
    if on_card:
        refused = [c for c in sizes if encode_plan(*shapes, c).clusters < 1]
        if refused:
            fail(f"the card admits no cluster of {refused} blocks of the whole-encode kernel")
    worst = 0.0
    for gate in (True, False):
        looped = (fm0[:few].clone(), bm0_pad[:few].clone(), res0[:few].clone())
        e1 = [cuda_fused_step(*looped, d2, gram_p, gate_tail=gate, **kw) for _ in range(few_steps)]
        e1 = [torch.stack(x) for x in zip(*e1)]
        plain = (fm0[:few].clone(), bm0_pad[:few].clone(), res0[:few].clone())
        e_plain = fused_encode_plain(*plain, d2, gram_p, n_steps=few_steps, gate_tail=gate, **kw)
        for c in sizes:
            st = (fm0[:few].clone(), bm0_pad[:few].clone(), res0[:few].clone())
            e2 = cuda_fused_encode(*st, d2, gram_p, n_steps=few_steps, gate_tail=gate, cluster=c,
                                   **kw)
            sync()
            name = f"fused encode, cluster of {c}, gate_tail={gate}"
            assert_identical(f"{name}, against the one-block step kernel looped", [
                ("atoms", e2.atoms, e1[0]), ("positions", e2.positions, e1[1]),
                ("values", e2.values, e1[2]), ("fm", st[0], looped[0]), ("bm", st[1], looped[1]),
                ("residual", st[2], looped[2]),
            ])
            assert_events(f"{name}, against plain", e2, e_plain)
            assert_close(f"{name} fm", st[0], plain[0], TAIL_TOL)
            assert_close(f"{name} bm", st[1], plain[1], TAIL_TOL)
            assert_close(f"{name} residual", st[2], plain[2], RESIDUAL_TOL)
            worst = max(worst, max_err(zip(st, plain)))
        del looped, plain
    records["cuda_fused_encode"]["max_abs_err"] = max(records["cuda_fused_encode"]["max_abs_err"],
                                                      worst)
    print(f"check cuda_fused_encode at cluster sizes {sizes}, {few} items x {few_steps} steps, "
          f"with and without the tail gate: bit-identical to cuda_fused_step looped (events, fm, "
          f"bm, residual), max abs err vs plain {worst:.3e}")
    # the lane-table encode: bit for bit the whole-encode kernel's result,
    # its plain version within the tail tolerance, and tables that describe
    # the final map
    lanes0 = initial_lanes(fm0, geom)
    lane_states = [(fm0.clone(), bm0_pad.clone(), lanes0.clone(), res0.clone()) for _ in range(2)]
    el = cuda_fused_encode_lane(*lane_states[0], d2, gram_p, n_steps=S, **kw)
    elp = fused_encode_lane_plain(*lane_states[1], d2, gram_p, n_steps=S, **kw)
    sync()
    fm_l, bm_l, lanes_l, res_l = lane_states[0]
    assert_identical("lane encode vs whole encode", [
        ("atoms", el.atoms, ek.atoms), ("positions", el.positions, ek.positions),
        ("values", el.values, ek.values), ("fm", fm_l, states[0][0]),
        ("bm", bm_l, states[0][1]), ("residual", res_l, states[0][2]),
    ])
    assert_lane_tables("lane encode", lane_states[0], geom)
    assert_events("lane encode vs plain", el, elp)
    assert_close("lane encode residual", res_l, lane_states[1][3], RESIDUAL_TOL)
    assert_close("lane encode fm", fm_l, lane_states[1][0], TAIL_TOL)
    assert_close("lane encode bm", bm_l, lane_states[1][1], TAIL_TOL)
    records["cuda_fused_encode_lane"] = dict(max_abs_err=max_err(
        [(a, b) for a, b in zip(lane_states[0], lane_states[1]) if a.dtype == torch.float32]
        + [(el.values, elp.values)]
    ))
    print(f"check cuda_fused_encode_lane, {S} steps: bit-identical to cuda_fused_encode (events, "
          f"fm, bm, residual), lanes == argmax and bm == max of every block of the final map, "
          f"max abs err vs plain {records['cuda_fused_encode_lane']['max_abs_err']:.3e}")
    del states, lane_states, fm_l, bm_l, lanes_l, res_l
    # at every cluster size, with and without the tail gate (which rewrites
    # the tail blocks at every step, outside the window of an interior
    # event), the whole batch and all steps: bit for bit the whole-encode
    # kernel at the same cluster size
    if on_card:
        refused = [c for c in sizes if encode_plan(*shapes, c, True).clusters < 1]
        if refused:
            fail(f"the card admits no cluster of {refused} blocks of the lane-table encode")
    for gate in (True, False):
        for c in sizes:
            whole = (fm0.clone(), bm0_pad.clone(), res0.clone())
            e2 = cuda_fused_encode(*whole, d2, gram_p, n_steps=S, gate_tail=gate, cluster=c, **kw)
            lane = (fm0.clone(), bm0_pad.clone(), lanes0.clone(), res0.clone())
            e5 = cuda_fused_encode_lane(*lane, d2, gram_p, n_steps=S, gate_tail=gate, cluster=c,
                                        **kw)
            sync()
            name = f"lane encode, cluster of {c}, gate_tail={gate}"
            assert_identical(f"{name}, against the whole encode at the same size", [
                ("atoms", e5.atoms, e2.atoms), ("positions", e5.positions, e2.positions),
                ("values", e5.values, e2.values), ("fm", lane[0], whole[0]),
                ("bm", lane[1], whole[1]), ("residual", lane[3], whole[2]),
            ])
            assert_lane_tables(name, lane, geom)
            del whole, lane
    print(f"check cuda_fused_encode_lane at cluster sizes {sizes}, {B} items x {S} steps, with "
          f"and without the tail gate: bit-identical to cuda_fused_encode at the same size "
          f"(events, fm, bm, residual), lanes == argmax of every block, pad lanes 0")
    del fm0, bm0, bm0_pad, res0, windows, lanes0

    for vpu in (False, True):
        want = probe_plain(vpu, PROBE_STEPS, dev)
        for kind, programmatic in PROBE_KINDS.values():
            got = probe_launches(kind, vpu, PROBE_STEPS, dev, programmatic=programmatic)
            sync()
            assert_identical(f"probe {kind} (programmatic={programmatic}) vpu={vpu}",
                             [("tile", got, want)])
    records["probe_launches"] = dict(max_abs_err=0.0)
    print(f"check probe_launches vs plain, {PROBE_STEPS} steps, {', '.join(PROBE_KINDS)}, with "
          f"and without the arithmetic: tiles bit-identical (tile[0, 0] = "
          f"{float(want[0, 0]):.3f})")

    # ---- phase 3: the paths, through sparse_code_fast
    d_b_np, sig_b_np = bench_inputs(cfg)
    d_b = torch.from_numpy(d_b_np).to(dev)
    sig_b = torch.from_numpy(sig_b_np).to(dev)
    bench_kw = dict(n_steps=S, fused=True, pipelined=True, whole_loop=True, block=block,
                    depth=cfg["depth"])

    kernels.reset_launches()
    out = sparse_code_fast(sig_b, d_b, **bench_kw)   # warm-up
    sync()
    runs, t_e2e = 3, []
    for _ in range(runs):
        t0 = time.perf_counter()
        out = sparse_code_fast(sig_b, d_b, **bench_kw)
        sync()
        t_e2e.append((time.perf_counter() - t0) * 1e3)
    main_launches = dict(kernels.LAUNCHES)
    if main_launches["cuda_fused_encode"] != (runs + 1 if on_card else 0):
        fail(f"bench path: {main_launches} for {runs + 1} encodes")
    records["cuda_fused_encode"]["launches"] = main_launches["cuda_fused_encode"]
    if not all(torch.isfinite(t).all() for t in (out.values, out.residual)):
        fail("bench path: non-finite output")
    if tuple(out.atom_indices.shape) != (S, B) or tuple(out.residual.shape) != (B, 1, n):
        fail("bench path: wrong output shapes")
    recon = reconstruct_from_events(out, d_b)
    e_sig = float((sig_b.double() ** 2).sum())
    e_res = float((out.residual.double() ** 2).sum())
    e_err = float(((sig_b - recon).double() ** 2).sum())
    if not e_res < e_sig:
        fail("bench path: residual energy not below signal energy")
    snr = 10 * np.log10(e_sig / e_err)
    ms = float(np.mean(t_e2e))

    # the same encode through the lane-table path, launches counted alike
    lane_kw = dict(bench_kw, lane_table=True)
    kernels.reset_launches()
    lane_out = sparse_code_fast(sig_b, d_b, **lane_kw)   # warm-up
    sync()
    t_lane = []
    for _ in range(runs):
        t0 = time.perf_counter()
        lane_out = sparse_code_fast(sig_b, d_b, **lane_kw)
        sync()
        t_lane.append((time.perf_counter() - t0) * 1e3)
    lane_launches = dict(kernels.LAUNCHES)
    want = {k: (runs + 1 if k == "cuda_fused_encode_lane" and on_card else 0)
            for k in lane_launches}
    if lane_launches != want:
        fail(f"lane-table bench path: {lane_launches} for {runs + 1} encodes")
    assert_events("lane-table bench path vs bench path", lane_out, out)
    lane_path_ms = float(np.mean(t_lane))
    print(f"bench path with lane_table=True: {lane_path_ms:.3f} ms per encode (runs "
          f"{', '.join(f'{t:.3f}' for t in t_lane)}); launches {lane_launches}")
    del lane_out

    d2_b = unit_norm(d_b)
    gram_ms = timed(lambda: dictionary_gram(d2_b), 3, dev)
    corr_ms = timed(lambda: encode_state(sig_b, d2_b, geom), 3, dev)
    gram_b = F.pad(dictionary_gram(d2_b), (0, 1))

    def fresh_encode_state():
        fm, bm, res = encode_state(sig_b, d2_b, geom)
        return fm, F.pad(bm, (0, geom.nb_pad - geom.n_blocks), value=-3e38), res

    # the whole-encode kernel and the lane-table encode back to back on
    # copies of the same fresh state, in turns (K2 first, then K5 first)
    enc_ms, lane_ms, found, found_l = [], [], [], []
    for r in range(4):
        fm_t, bm_t, res_t = fresh_encode_state()
        st = (fm_t.clone(), bm_t.clone(), res_t.clone())
        st_l = (fm_t, bm_t, initial_lanes(fm_t, geom), res_t)
        runs_k = [
            (enc_ms, lambda: found.append(cuda_fused_encode(*st, d2_b, gram_b, n_steps=S, **kw))),
            (lane_ms, lambda: found_l.append(
                cuda_fused_encode_lane(*st_l, d2_b, gram_b, n_steps=S, **kw))),
        ]
        for times, fn in (runs_k if r % 2 == 0 else runs_k[::-1]):
            times.append(timed(fn, 1, dev, warmup=False))
        del st, st_l, fm_t, bm_t, res_t
    ev = found[-1]
    kernel_ms = float(np.mean(enc_ms))
    assert_events("encode kernel vs bench path", ev, (out.atom_indices, out.positions, out.values))
    assert_events("lane encode kernel vs bench path", found_l[-1],
                  (out.atom_indices, out.positions, out.values))
    st = fresh_encode_state()
    sync()
    t0 = time.perf_counter()
    fused_encode_plain(*st, d2_b, gram_b, n_steps=S, **kw)
    sync()
    plain_ms = (time.perf_counter() - t0) * 1e3
    del st
    b_bytes, b_flops = step_traffic(cfg, geom, ev.positions, chain=False)
    b_bytes += 4 * 2 * (B * N * geom.nb_pad + B * (n + A))   # table and residuals, once
    bms, by = bound(b_bytes, b_flops, peaks)
    records["cuda_fused_encode"].update(ms=kernel_ms, plain_ms=plain_ms, bound_ms=bms,
                                        bound_by=by, library_ms=None)
    if on_card:
        for name, lanes in (("cuda_fused_encode", False), ("cuda_fused_encode_lane", True)):
            c = encode_cluster_size(B, N, lambda c: encode_plan(*shapes, c, lanes).clusters)
            plan = encode_plan(*shapes, c, lanes)
            print(f"bench path: {name} runs {B} clusters of {c} blocks "
                  f"({plan.smem_bytes} bytes of shared memory a block: ring of {plan.stages} "
                  f"stages, {'tables' if lanes else 'table'} "
                  f"{'on chip' if plan.table_on_chip else 'in global memory'}); the card holds "
                  f"{plan.clusters} such clusters at once (cudaOccupancyMaxActiveClusters)")
            if plan.clusters < B:
                fail(f"{name}: {B} clusters, {plan.clusters} resident: the encode runs in waves")
    print(f"bench path (sparse_code_fast, fused whole-loop, block {block}, depth "
          f"{cfg['depth']}): {S * B / (ms / 1e3):.1f} atoms/s, {ms:.3f} ms per encode "
          f"(runs {', '.join(f'{t:.3f}' for t in t_e2e)}); split: gram {gram_ms:.3f} ms, "
          f"correlation {corr_ms:.3f} ms, kernel {kernel_ms:.3f} ms; launches {main_launches} "
          f"for {runs + 1} encodes; SNR {snr:.3f} dB; "
          f"{int((ev.positions > n - A).sum())} clipped events")
    fm_t, bm_t, res_t = fresh_encode_state()
    st = (fm_t, bm_t, initial_lanes(fm_t, geom), res_t)
    sync()
    t0 = time.perf_counter()
    fused_encode_lane_plain(*st, d2_b, gram_b, n_steps=S, **kw)
    sync()
    lane_plain_ms = (time.perf_counter() - t0) * 1e3
    del st, fm_t, bm_t, res_t
    l_bytes, l_flops = step_traffic(cfg, geom, found_l[-1].positions, chain=False,
                                    lane_table=True)
    l_bytes += 4 * 2 * (2 * B * N * geom.nb_pad + B * (n + A))   # both tables, residuals, once
    bms, by = bound(l_bytes, l_flops, peaks)
    lane_kernel_ms = float(np.mean(lane_ms))
    records["cuda_fused_encode_lane"].update(
        ms=lane_kernel_ms, plain_ms=lane_plain_ms, bound_ms=bms, bound_by=by, library_ms=None,
        ms_whole_encode_same_run=kernel_ms, ms_lane_path=lane_path_ms)
    print(f"time cuda_fused_encode_lane against cuda_fused_encode, copies of the same fresh "
          f"bench state in turns, ms per encode: {lane_kernel_ms:.3f} (runs "
          f"{', '.join(f'{t:.3f}' for t in lane_ms)}) against {kernel_ms:.3f} (runs "
          f"{', '.join(f'{t:.3f}' for t in enc_ms)}), ratio {lane_kernel_ms / kernel_ms:.3f}; "
          f"bound {bms:.3f} ms ({by}), reached to {bms / lane_kernel_ms:.2f}; end to end, the "
          f"lane_table=True path {lane_path_ms:.3f} ms per encode beside the main path's "
          f"{ms:.3f}")
    del gram_b, out, recon

    naive = sparse_code(sig_pl, d_pl, n_steps=S)
    enc = sparse_code_fast(sig_pl, d_pl, **bench_kw)
    assert_events("fused encode vs naive sparse_code (planted)", enc, naive)
    assert_close("fused encode vs naive residual", enc.residual, naive.residual, RESIDUAL_TOL)
    print(f"naive sparse_code vs fused encode, planted full-width signal, {S} steps: events equal")

    for name, path_kw, expected in (
        ("cuda_fused_step_pipelined", dict(fused=True), S),   # pipelined is the default
        ("cuda_fused_step", dict(fused=True, pipelined=False), S),
        ("cuda_fused_encode_lane",
         dict(fused=True, whole_loop=True, lane_table=True, depth=cfg["depth"]), 1),
        ("cuda_boundary_update", dict(use_pallas=True, block_argmax=True), S),
    ):
        kernels.reset_launches()
        res = sparse_code_fast(sig_pl, d_pl, n_steps=S, block=block, **path_kw)
        sync()
        launches = dict(kernels.LAUNCHES)
        want = {k: (expected if k == name and on_card else 0) for k in launches}
        if launches != want:
            fail(f"{path_kw} path: {launches}, expected {expected} launches of {name} alone")
        records[name]["launches"] = launches[name]
        assert_events(f"{path_kw} path vs naive sparse_code", res, naive)
        assert_close(f"{path_kw} path residual", res.residual, naive.residual, RESIDUAL_TOL)
        print(f"path sparse_code_fast({path_kw}), planted signal: launches {launches}, "
              f"events equal to naive")
    del naive, enc, res

    multiband_phase(dev, mb, peaks, sync, records)

    probe_phase(dev, peaks, sync, records)

    sparse_layer_phase(dev, cfg, records)

    splat_phase(dev, splat, sync)

    siam_phase(dev, siam, sync)

    ssm_phase(dev, ssm, sync)

    siam_train_phase(dev, siam_train, sync)

    models_phase(dev, models, sync, records)

    longtail_phase(dev, longtail, sync)

    perceptual_phase(dev, perceptual, sync)

    zoo_phase(dev, zoo, sync)

    # ---- phase 5: per-kernel times
    fm, bm, res = encode_state(sig_b, d2_b, geom)
    windows = res[:, tail_idx].contiguous()
    k3_ms = timed(lambda: cuda_boundary_update(fm, bm, windows, d2_b, geom.tail_start, block), 20, dev)
    k3_plain = timed(lambda: boundary_update_plain(fm, bm, windows, d2_b, geom.tail_start, block), 5, dev)

    def library_call():
        with no_tf32():
            return torch.matmul(d2_b, windows.transpose(1, 2))

    k3_lib = timed(library_call, 20, dev)
    gather_ms = timed(lambda: res[:, tail_idx], 20, dev)
    print(f"time residual[:, tail_idx] (the gather that builds windows {tuple(windows.shape)} at "
          f"every step of the use_pallas path, outside the kernel): {gather_ms:.4f} ms")
    k3_bytes = 4 * (B * A * A + N * A + B * N * A + B * N * (A // block))
    bms, by = bound(k3_bytes, 2 * B * N * A * A, peaks)
    records["cuda_boundary_update"].update(ms=k3_ms, plain_ms=k3_plain, bound_ms=bms, bound_by=by,
                                           library_ms=k3_lib)
    del windows

    gram_b = F.pad(dictionary_gram(d2_b), (0, 1))
    reps = 20   # every chain below runs the same first steps of the bench encode
    step_state = (fm, bm, res)

    def chain_ms(fn, **opts):
        """(ms per step, events) of ``reps`` steps by one call of ``fn`` on a
        fresh copy of the state."""
        st = tuple(t.clone() for t in step_state)
        found = []
        ms = timed(lambda: found.append(fn(*st, d2_b, gram_b, **opts, **kw)), 1, dev, warmup=False)
        return ms / reps, found[0]

    def singles(*st):
        return stack_events([cuda_fused_step_pipelined(*st, d2_b, gram_b, **kw)
                             for _ in range(reps)])

    chain_ms(cuda_fused_step_pipelined, n_steps=reps)   # warm-up
    k4_ms, k4_ev = chain_ms(cuda_fused_step_pipelined, n_steps=reps)
    k4_serial_ms, _ = chain_ms(cuda_fused_step_pipelined, n_steps=reps, programmatic=False)
    k4_single_ms, _ = chain_ms(lambda *a, **k: singles(*a[:3]))
    chain_ms(cuda_fused_step, n_steps=reps)
    k1_ms, k1_ev = chain_ms(cuda_fused_step, n_steps=reps)
    k1_serial_ms, _ = chain_ms(cuda_fused_step, n_steps=reps, programmatic=False)
    assert_identical("the timed chains of the two step kernels", [
        ("atoms", k4_ev.atoms, k1_ev.atoms), ("positions", k4_ev.positions, k1_ev.positions),
        ("values", k4_ev.values, k1_ev.values),
    ])
    k1_plain = timed(lambda: fused_step_plain(fm, bm, res, d2_b, gram_b, **kw), 5, dev)
    b_bytes, b_flops = step_traffic(cfg, geom, k1_ev.positions, chain=True)
    bms, by = bound(b_bytes / reps, b_flops / reps, peaks)
    records["cuda_fused_step"].update(ms=k1_ms, plain_ms=k1_plain, bound_ms=bms, bound_by=by,
                                      library_ms=None, ms_serial=k1_serial_ms)
    records["cuda_fused_step_pipelined"].update(ms_bench=k4_ms, bound_ms_bench=bms,
                                                ms_bench_serial=k4_serial_ms)
    print(f"time the step kernels at the bench shapes, chains of the same {reps} steps "
          f"({int((k1_ev.positions > n - A).sum())} clipped events), ms per step: "
          f"cuda_fused_step_pipelined {k4_ms:.4f} ({k4_serial_ms:.4f} without programmatic "
          f"serialization, {k4_single_ms:.4f} launched one by one), cuda_fused_step {k1_ms:.4f} "
          f"({k1_serial_ms:.4f} without), bound {bms:.4f} ms"
          + (f"; the rule gives {B} items clusters of "
             f"{cluster_size(B, N, lambda c: step_plan(*shapes, c).clusters)}"
             if on_card else ""))
    if on_card:
        sweep = {c: chain_ms(cuda_fused_step_pipelined, n_steps=reps, cluster=c)[0]
                 for c in (1, 2, 4, 8, 16)}   # the same steps again, at every cluster size
        print("time cuda_fused_step_pipelined at the bench shapes by cluster size "
              f"(ms per step, clusters the card holds at once, ring stages): "
              + ", ".join(f"{c}: {sweep[c]:.4f} ({step_plan(*shapes, c).clusters}, "
                          f"{step_plan(*shapes, c).stages})" for c in sweep))
        k2_sweep, k5_sweep = {}, {}
        for c in sizes:   # the bench encode again, at every cluster size, both kernels
            fm_t, bm_t, res_t = fresh_encode_state()
            st = (fm_t.clone(), bm_t.clone(), res_t.clone())
            st_l = (fm_t, bm_t, initial_lanes(fm_t, geom), res_t)
            k2_sweep[c] = timed(
                lambda: cuda_fused_encode(*st, d2_b, gram_b, n_steps=S, cluster=c, **kw),
                1, dev, warmup=False)
            k5_sweep[c] = timed(
                lambda: cuda_fused_encode_lane(*st_l, d2_b, gram_b, n_steps=S, cluster=c, **kw),
                1, dev, warmup=False)
            del st, st_l, fm_t, bm_t, res_t
        for name, sweep, lanes in (("cuda_fused_encode", k2_sweep, False),
                                   ("cuda_fused_encode_lane", k5_sweep, True)):
            plans = {c: encode_plan(*shapes, c, lanes) for c in sweep}
            print(f"time {name} at the bench shapes by cluster size: ms per encode "
                  "(clusters the card holds at once, ring stages, tables on chip): "
                  + ", ".join(f"{c}: {ms:.3f} ({plans[c].clusters}, {plans[c].stages}, "
                              f"{plans[c].table_on_chip})" for c, ms in sweep.items()))
        # what a wave costs: as many items as clusters of 4 are resident at once
        fit = encode_plan(*shapes, 4).clusters if N % 4 == 0 else 0
        if 0 < fit < B:
            st = tuple(t[:fit].contiguous() for t in fresh_encode_state())
            fit_ms = timed(lambda: cuda_fused_encode(*st, d2_b, gram_b, n_steps=S, cluster=4, **kw),
                           1, dev, warmup=False)
            del st
            print(f"time cuda_fused_encode, the first {fit} of the {B} items (all that clusters of "
                  f"4 hold at once), cluster of 4: {fit_ms:.3f} ms per encode")
    for name, r in records.items():
        lib = "" if r["library_ms"] is None else f", library (torch.matmul) {r['library_ms']:.4f} ms"
        print(f"time {name}: {r['ms']:.4f} ms per launch, plain {r['plain_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}){lib}")
    return records


# the keys every kernel's record has; a record may carry more times
KEYS = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")

SOURCES = {
    "cuda_fused_step": ("mptpu_torch/csrc/mp_fused.cu", "mptpu/sparse/pallas_fused_mp.py:289"),
    "cuda_fused_encode": ("mptpu_torch/csrc/mp_fused.cu", "mptpu/sparse/pallas_fused_mp.py:1219"),
    "cuda_boundary_update": ("mptpu_torch/csrc/mp_boundary.cu", "mptpu/sparse/pallas_mp.py:58"),
    "cuda_fused_step_pipelined": ("mptpu_torch/csrc/mp_pipelined.cu",
                                  "mptpu/sparse/pallas_fused_mp.py:727"),
    "cuda_fused_encode_lane": ("mptpu_torch/csrc/mp_lane.cu",
                               "mptpu/sparse/pallas_fused_mp.py:1692"),
    "probe_launches": ("mptpu_torch/csrc/probe.cu", "scripts/grid_overhead_probe.py:84"),
}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    if not (ROOT / "mptpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: the mptpu_torch package is not beside {__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from mptpu_torch import kernels, parity_mode

    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi)
    kind = torch.cuda.get_device_name(0)
    peaks = next((v for k, v in PEAKS.items() if k in kind), PEAKS["H100"])
    print(f"peaks used for bounds: {peaks[0] / 1e12:.2f} TB/s, {peaks[1] / 1e12:.0f} TFLOP/s f32")

    t0 = time.perf_counter()
    kernels.library()
    regs = [ln.strip() for ln in kernels.build_log.splitlines() if "registers" in ln]
    print(f"build: {time.perf_counter() - t0:.1f} s; ptxas: {' | '.join(regs)}")

    parity_mode()
    dev = torch.device("cuda", 0)
    records = run(dev, BENCH, peaks, torch.cuda.synchronize)

    line = []
    for name, r in records.items():
        source, replaces = SOURCES[name]
        extra = {k: v for k, v in r.items() if k not in KEYS}
        line.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                         **{k: r[k] for k in KEYS}, **extra))
    print(smi)   # again here, so that the end of the output names the card
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
