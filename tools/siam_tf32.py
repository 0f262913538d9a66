#!/usr/bin/env python3
"""How far the SIAM trainer's float32 gradients on a CUDA card are from
the CPU's, with its backward in full float32 and, as a control, in TF32.

    python3 tools/siam_tf32.py

At full width under sw6's flags (``chip_smoke.py``'s phase 9(b): 2^17
samples, 32 events, hidden 128, context 32, STFT 2048/256), with TF32
allowed for the process, it runs one forward and backward of
``SIAMOverfitStep.grads`` on the CPU in float32 and twice on the card: as
the trainer runs it (the backward inside ``no_tf32``) and with ``grads``
replaced by the same code without that block, so that the backward's
convolutions and products may run in TF32. It does so at two states: the
parameters of a generator seeded 0, and the same after phase 9(a)'s 30
steps of ``overfit_siam`` (the state phase 9(b) holds). It prints each
run's gradients by group against the CPU's (max abs error over the
largest), from which phase 9's float32 limit is set. Needs a card.
"""

from __future__ import annotations

import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("siam_tf32: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from mptpu_torch import parity_mode
    from mptpu_torch.data import synthetic_audio
    from mptpu_torch.models import siam as siam_mod
    from mptpu_torch.models.siam_overfit import (SW6, SIAMOverfitStep, overfit_siam,
                                                 siam_overfit_loss, siam_sizes)
    from mptpu_torch.nn.init import uniform
    from mptpu_torch.sparse import quantize

    parity_mode()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    dev = torch.device("cuda", 0)
    sz = siam_sizes(False)
    n, E = sz["n_samples"], sz["n_events"]
    model = siam_mod.SIAMModel(
        n_samples=n, context_dim=sz["context_dim"], in_channels=sz["window"] // 2 + 1,
        hidden_channels=sz["hidden"], n_events=E, transform_window_size=sz["window"],
        transform_step_size=sz["step"], attn_floor=SW6["attn_floor"], attn_leak=SW6["attn_leak"],
        switch_bias_init=SW6["switch_bias_init"], switch_clamp=20.0, residual_clamp_scale=4.0,
        encoder_clamp=1e4, vec_clamp=SW6["vec_clamp"], generator=torch.Generator().manual_seed(0),
        device="cpu")
    state = model.state_dict()
    groups = chip_smoke.siam_train_groups(model)
    noise = uniform((E, 1, 1, min(8192, n)), -1.0, 1.0, torch.Generator(device=dev).manual_seed(0))
    seg = synthetic_audio(n, 22050, n_events=SW6["audio_events"], seed=SW6["seed"],
                          sustained=True).reshape(1, 1, n)

    def sync():
        torch.cuda.synchronize(dev)

    def grads_in_tf32(self, noise, wave_w, f_tgt, tgt, tgt_e_half, generator=None):
        loss, aux = siam_overfit_loss(self.model, self.settings, noise, wave_w, f_tgt, tgt,
                                      tgt_e_half, generator)
        grads = torch.autograd.grad(loss, self.params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(self.params, grads)]
        return loss.detach(), aux, grads

    cfg = chip_smoke.SIAM_TRAIN
    with tempfile.TemporaryDirectory() as tmp:
        trained = overfit_siam(**dict(SW6, tiny=False, iterations=cfg["steps"],
                                      eval_every=cfg["eval_every"],
                                      walk_eval_every=cfg["walk_eval_every"]),
                               out=tmp, noise=noise, device=dev, log=lambda line: None)
    states = {"seed 0": state,
              f"after {cfg['steps']} steps": {k: v.detach().cpu() for k, v in
                                              trained.trainer.model.state_dict().items()}}
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    quantize.set_selection_leak(SW6["selection_leak"])
    quantize.set_selection_floor(SW6["selection_floor"])
    for at, state in states.items():
        cpu = chip_smoke.siam_train_one_step(torch.device("cpu"), torch.float32, state, seg,
                                             noise, False, sync)
        runs = {"backward in full float32 (the trainer)":
                chip_smoke.siam_train_one_step(dev, torch.float32, state, seg, noise, False, sync)}
        kept = SIAMOverfitStep.grads
        SIAMOverfitStep.grads = grads_in_tf32
        try:
            runs["backward in TF32 (control)"] = chip_smoke.siam_train_one_step(
                dev, torch.float32, state, seg, noise, False, sync)
        finally:
            SIAMOverfitStep.grads = kept
        for what, card in runs.items():
            frames = torch.equal(card[1], cpu[1])
            errs = {g: max(chip_smoke.share_err(card[4][k], cpu[4][k]) for k in names)
                    for g, names in groups.items()}
            print(f"siam_tf32, parameters {at}, {what}, card against CPU in float32 with TF32 "
                  f"allowed for the process: frames {'identical' if frames else 'DIFFERENT'}, "
                  f"loss {card[3]:.6f} against {cpu[3]:.6f}; gradients by group, max abs err "
                  f"over the largest: " + ", ".join(f"{g} {e:.2e}" for g, e in errs.items())
                  + f"; largest {max(errs.values()):.2e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
