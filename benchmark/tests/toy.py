"""Toy sizes of each traffic loop, for runs on the CPU."""

import time

import torch

from benchmark import harness

TOY = {
    "frames": dict(width=32, height=18, spp=2, spb=2, rays_per_chunk=192,
                   check_pixels=96, check_frames=2, reference_block=512,
                   trace_after_s=0.0, trace_units=1),
    "fit_step": dict(width=32, height=18, target_spp=4, target_spb=2,
                     rays_per_chunk=256, pixels_per_step=256, spb=2,
                     roi=[0, 18, 0, 32], reference_block=512,
                     trace_after_s=0.0, trace_units=1),
}
CELLS = ("standin-inverse-crn", "shirley-frame-720p", "standin-frame-720p")
SEED = 2**31 + 977


def toy_cell(name):
    cell = harness.find_cell(name)
    cell.traffic.update(TOY[cell.traffic["loop"]])
    return cell


def run(name, seconds=0.5, trace=0, control=None, seed=SEED):
    """One run of ``name`` at toy size on the CPU, the harness's look for
    a card skipped."""
    cell = toy_cell(name)
    logs = []
    out = harness.run_cell(cell, seed, seconds, trace,
                           harness.Device(torch, "cpu"), time.perf_counter(),
                           control=control, log=lambda *a: logs.append(a))
    return out
