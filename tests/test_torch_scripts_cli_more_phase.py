"""``chip_smoke.more_command_lines_phase`` (phase 17, the eleven remaining
command lines and ``train_siam`` across ranks) end to end on the CPU at
``CLI_MORE_SMALL``'s flags: every command line in process, the resume and
``torchrun`` in processes of their own, two gloo ranks, their files and
gates; no kernel launches off a card."""

import torch


def test_chip_phase_rehearsal():
    import chip_smoke
    from mptpu_torch.utils.profile import device_peaks

    kept = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        records = {"cuda_fused_step_pipelined": {}}
        chip_smoke.more_command_lines_phase(torch.device("cpu"),
                                            dict(chip_smoke.CLI_MORE_SMALL, sw6=None),
                                            device_peaks("H100"), lambda: None, records)
    finally:
        torch.set_num_threads(kept)
    assert records["cuda_fused_step_pipelined"] == dict(launches_cli_multiband_parity=0)
