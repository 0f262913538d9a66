"""``chip_smoke.command_lines_phase`` (phase 16, the command lines) end to
end on the CPU at ``CLI_SMALL``'s flags: every command line in process and
the two in processes of their own, their files and gates; no kernel
launches off a card."""

import torch


def test_chip_phase_rehearsal():
    import chip_smoke
    from mptpu_torch.utils.profile import device_peaks

    kept = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        records = {"cuda_fused_step_pipelined": {}}
        chip_smoke.command_lines_phase(torch.device("cpu"), dict(chip_smoke.CLI_SMALL, sw6=None),
                                       device_peaks("H100"), lambda: None, records)
    finally:
        torch.set_num_threads(kept)
    assert records["cuda_fused_step_pipelined"] == dict(
        launches_cli_mp_train=0, launches_cli_mp_train_multiband=0, launches_cli_build_index=0)
