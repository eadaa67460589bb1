"""``parallel.launch.run_ranks`` and ``entry.dryrun_multichip`` on the
CPU: the dry run on 8 ``gloo`` ranks (tests/test_distributed.py's
``test_graft_entry_and_dryrun`` on the port) and on 3; a rank that
raises, hangs or exits without a result ends the run (at its timeout for a
hang, at once otherwise), with every rank killed; no mesh puts a
``gloo`` group over the card, and without a card nothing starts unless
the CPU is asked for."""

import os
import sys
import time

import pytest
import torch
import torch.distributed as dist

from mini_tpu_torch.parallel.launch import run_ranks


def _rank_result():
    return {"rank": dist.get_rank(), "world": dist.get_world_size(),
            "backend": str(dist.get_backend()), "pid": os.getpid(),
            "threads": torch.get_num_threads(),
            "t": torch.arange(3) * dist.get_world_size()}


def _raise_on_rank_1():
    if dist.get_rank() == 1:
        raise ValueError("rank 1 fails on purpose")
    dist.barrier()  # the others wait for rank 1 in a collective


def _exit_0_on_rank_1():
    if dist.get_rank() == 1:
        sys.exit(0)  # ends the process with code 0 and no result
    time.sleep(120)  # the others still at work (over NCCL, in a collective)


def _hang_on_rank_1():
    if dist.get_rank() == 1:
        time.sleep(3600)
    dist.barrier()


def _card_mesh_on_gloo():
    from mini_tpu_torch.parallel import make_mesh

    with pytest.raises(RuntimeError, match="nccl"):
        make_mesh(device="cuda")
    return True


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


def test_run_ranks_returns_rank_0_result():
    out = run_ranks(_rank_result, 3, device="cpu", timeout_s=120)
    assert (out["rank"], out["world"], out["backend"]) == (0, 3, "gloo")
    assert out["threads"] == 1 and torch.equal(out["t"], torch.arange(3) * 3)
    assert not _alive(out["pid"])


def test_run_ranks_raises_when_a_rank_raises():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        run_ranks(_raise_on_rank_1, 3, device="cpu", timeout_s=120)
    assert time.monotonic() - t0 < 60  # not the collective's timeout


def test_run_ranks_names_a_rank_that_exits_0_without_a_result():
    """A rank whose function calls ``sys.exit(0)`` ends with code 0 and no
    result: ``run_ranks`` names it within seconds, not at its timeout."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError,
                       match="rank 1 exited with code 0 and no result"):
        run_ranks(_exit_0_on_rank_1, 3, device="cpu", timeout_s=120)
    assert time.monotonic() - t0 < 40  # not the timeout: rank 1 is named


def test_run_ranks_kills_a_hung_rank_at_its_timeout():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        run_ranks(_hang_on_rank_1, 2, device="cpu", timeout_s=8)
    assert time.monotonic() - t0 < 8 + 30


def test_no_gloo_mesh_over_the_card():
    assert run_ranks(_card_mesh_on_gloo, 2, device="cpu", timeout_s=120)


def test_run_ranks_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        run_ranks(_rank_result, 2)


def test_dryrun_multichip_on_8_gloo_ranks():
    """Part 2's step on a 4 x 2 (graph, feat) mesh."""
    from mini_tpu_torch.entry import dryrun_multichip

    dryrun_multichip(8, device="cpu")


def test_dryrun_multichip_on_3_gloo_ranks():
    """An odd count: no 2-level mesh, part 2's step on a 3 x 1 mesh."""
    from mini_tpu_torch.entry import dryrun_multichip

    dryrun_multichip(3, device="cpu")
