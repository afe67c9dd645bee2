"""Cells cut to a size a CPU test can hold: a few lanes, one-cycle
episodes, and the single-problem solver in the megakernel's place (on the
CPU the megakernel's plain version pads every batch to a 128-lane block)."""

import torch

from portbench import registry


def cell(name, batch=4):
    torch.set_num_threads(2)
    c = registry.cell(name)
    c.traffic = {**c.traffic, "batch": batch, "check_lanes": batch}
    c.config = {**c.config, "backend": "vmap"}
    if c.traffic["kind"] == "mpc":
        c.traffic["episode_cycles"] = 1
    return c
