"""Small configurations of the cells for the CPU tests: RAFT big (its
widths are fixed) at 64x64 frames with 2 GRU iterations, LAFC, FGT and
the discriminator at small widths."""

import copy
import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load(*parts):
    with open(os.path.join(ROOT, *parts)) as f:
        return json.load(f)


def removal(precision="bf16", hole="square"):
    cfg = load("configs", "fgt_removal_432x240.json")
    cfg["precision"] = precision
    cfg["raft"]["iters"] = 2
    cfg["lafc"]["cnum"] = 8
    cfg["fgt"].update(cnum=8, flow_cnum=8, frame_hidden=32, flow_hidden=16,
                      numBlocks=2, mlp_ratio=2, sw=4, gd=2, res_h=64,
                      res_w=64)
    cfg["profile_clips"] = 1
    # RAFT's flow head at its full scale: at 2 GRU iterations a tenth of
    # it moves the flows by a tenth of a pixel, too little to judge
    cfg["weight_scale"]["raft"] = {}
    mix = {"kind": "removal_clips", "frames": 6, "height": 64, "width": 64,
           "pan_px": 2, "pool": 2}
    mix["hole"] = ({"kind": "square", "size": 16, "y0": 20, "x0": 20}
                   if hole == "square" else
                   {"kind": "strokes", "mask_seeds": [1, 2], "brush": [3, 8],
                    "n_stroke": 2})
    return cfg, mix


def train(precision="bf16"):
    cfg = load("configs", "fgt_gan_train_240x432.json")
    cfg["precision"] = precision
    cfg["generator"].update(cnum=8, flow_cnum=8, frame_hidden=32,
                            flow_hidden=16, numBlocks=2, mlp_ratio=2, sw=4,
                            gd=2, res_h=64, res_w=64)
    cfg["flow_config"]["cnum"] = 8
    cfg["dist_cnum"] = 4
    cfg["profile_steps"] = 2
    mix = copy.deepcopy(load("traffic", "train_strokes_b2.json"))
    mix.update(height=64, width=64)
    mix["hole"].update(mask_seeds=[1, 2, 3], brush=[3, 6])
    mix["pool"] = 3
    return cfg, mix


def loose(limits):
    return {k: (0 if k == "frame_outside_max" else 1e9) for k in limits}
