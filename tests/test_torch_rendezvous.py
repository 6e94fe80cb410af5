"""Ranks that ``common.launch`` spawns on one host meet without a probed
port: with the TCP port that a probe would return held by another
process's live socket, a two-rank CPU launch still completes and its
ranks reduce across the group."""

import argparse
import os
import socket

import torch
import torch.distributed as dist

import pika_tpu_torch.parallel.mesh as mesh
from pika_tpu_torch.train import common

torch.set_num_threads(1)


def _rank_sum(args, device) -> None:
    x = torch.full((1,), float(dist.get_rank() + 1))
    dist.all_reduce(x)
    with open(os.path.join(args.out, f"rank{dist.get_rank()}"), "w") as f:
        f.write(f"{x.item():g}")


def test_spawned_ranks_meet_while_a_probed_port_is_taken(tmp_path, monkeypatch):
    with socket.socket() as held:
        held.bind(("127.0.0.1", 0))
        held.listen()
        port = held.getsockname()[1]
        # a port probe anywhere in the launch path would return the held port
        for module in (mesh, common):
            monkeypatch.setattr(module, "free_port", lambda: port, raising=False)
        args = argparse.Namespace(device="cpu", num_devices=2, num_processes=1, process_id=0,
                                  coordinator_address=None, dp_mode="sync", out=str(tmp_path))
        common.launch(args, _rank_sum)
    assert sorted(os.listdir(tmp_path)) == ["rank0", "rank1"]
    assert all((tmp_path / f"rank{r}").read_text() == "3" for r in (0, 1))
