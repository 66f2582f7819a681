"""The inputs are a function of `--seed` alone: the same seed gives the
same goals, problem order and episode goals, another seed others, and the
large seeds a driver draws work."""

import json
import os

import torch

from benchmark import harness
from benchmark.drivers import mpc, plan
from benchmark.reference import goals, scene
from benchmark.reference.robot import Robot

from .conftest import ROOT

BIG = 2 ** 31 + 12345


def test_goal_configurations_are_seeded_and_collision_free():
    cfg = harness.load_config(ROOT, "franka_ik")
    ref = Robot(os.path.join(cfg["_dir"], cfg["robot"]))
    a = goals.collision_free(ref, cfg["scene"], 64, goals.rng_of(BIG, 0), chunk=256)
    b = goals.collision_free(ref, cfg["scene"], 64, goals.rng_of(BIG, 0), chunk=256)
    c = goals.collision_free(ref, cfg["scene"], 64, goals.rng_of(BIG + 1, 0), chunk=256)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert ((a >= ref.lower) & (a <= ref.upper)).all()
    centres = ref.spheres(a)
    assert (ref.self_slack(centres) >= 0).all()
    assert (scene.clearance(centres, ref.sphere_radius, cfg["scene"]) >= 0).all()


def test_suite_permutations_are_seeded_and_whole():
    o1, s1 = plan.plan_order(BIG, 90, 3)
    o2, s2 = plan.plan_order(BIG, 90, 3)
    o3, s3 = plan.plan_order(7, 90, 3)
    assert (o1 == o2).all() and (s1 == s2).all() and not (o1 == o3).all()
    for k in range(3):
        part = slice(90 * k, 90 * (k + 1))
        assert sorted(o1[part].tolist()) == list(range(90))
        # every run plans the same (problem, seed) pairs, in another order
        assert sorted(zip(o1[part], s1[part])) == sorted(zip(o3[part], s3[part]))
    assert len(set(s1.tolist())) == len(s1)


def test_episode_goals_are_seeded():
    cfg = harness.load_config(ROOT, "franka_motion")
    with open(os.path.join(ROOT, "benchmark", "traffic", "mpc.json")) as fh:
        traffic = json.load(fh)
    ref = Robot(os.path.join(cfg["_dir"], cfg["robot"]))
    a, b = mpc.episode_goals(ref, traffic, BIG), mpc.episode_goals(ref, traffic, BIG)
    assert torch.equal(a, b) and not torch.equal(a, mpc.episode_goals(ref, traffic, 3))
    off = (a - ref.retract).abs()
    inside = (a > ref.lower) & (a < ref.upper)
    assert ((off >= 0.2 - 1e-12) & (off <= 0.4 + 1e-12))[inside].all()
    worlds = mpc.tick_worlds(cfg, traffic)
    drone = [next(o for o in w if o["name"] == "drone")["pose"][1] for w in worlds]
    assert abs(drone[1] - drone[0] + 0.004) < 1e-12 and len(worlds) == traffic["episode_ticks"]
