"""Generate robot YAML configs from a URDF (+ optional annex data).

Counterpart of `tools/import_urdf.py` inside the PyTorch package, over the
package's own copy of the URDF parser (`robot/urdf.py`), so that loading a
URDF never imports jax:

    python -m curobo_tpu_torch.robot.import_urdf <urdf> --base-link B \
        --tool-frames T1,T2 [--annex reference_robot_yaml] --out out.yml

The annex is a cuRobo-style robot YAML (or an XRDF document) from which
*data* (collision sphere centers/radii, self-collision ignore lists, cspace
defaults, lock joints, a floating-base chain of extra links) is extracted
into the `curobo-tpu-robot/1` schema. Only numeric/name data is read.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import yaml

from curobo_tpu_torch.robot import urdf as urdf_mod


def _floats(x):
    return [float(v) for v in x]


_TYPED_JOINTS = {
    "X_PRISM": ("prismatic", (1.0, 0.0, 0.0)),
    "Y_PRISM": ("prismatic", (0.0, 1.0, 0.0)),
    "Z_PRISM": ("prismatic", (0.0, 0.0, 1.0)),
    "X_ROT": ("revolute", (1.0, 0.0, 0.0)),
    "Y_ROT": ("revolute", (0.0, 1.0, 0.0)),
    "Z_ROT": ("revolute", (0.0, 0.0, 1.0)),
    "FIXED": ("fixed", (0.0, 0.0, 1.0)),
}


def _quat_to_rpy(ft):
    from scipy.spatial.transform import Rotation

    return Rotation.from_quat([ft[4], ft[5], ft[6], ft[3]]).as_euler("xyz")


def xrdf_to_annex(x: dict) -> dict:
    """Convert an XRDF document (format: xrdf, v1.0) into the annex shape
    this importer consumes. Parity: reference `util/xrdf_util.py`."""
    if x.get("format") != "xrdf":
        raise ValueError("not an XRDF document")
    kin: dict = {}
    cspace = x.get("cspace", {})
    joint_names = list(cspace.get("joint_names", []))
    kin["cspace"] = {
        "joint_names": joint_names,
        "max_acceleration": cspace.get("acceleration_limits", 15.0),
        "max_jerk": cspace.get("jerk_limits", 500.0),
    }
    djp = x.get("default_joint_positions")
    if djp:
        kin["cspace"]["default_joint_position"] = [
            float(djp.get(j, 0.0)) for j in joint_names
        ]
    kin["tool_frames"] = list(x.get("tool_frames", []))
    for mod in x.get("modifiers", []) or []:
        if "set_base_frame" in mod:
            kin["base_link"] = mod["set_base_frame"]
    geom = x.get("geometry", {})
    col = x.get("collision", {})
    if col.get("geometry") in geom:
        kin["collision_spheres"] = geom[col["geometry"]].get("spheres", {})
        buf = col.get("buffer_distance")
        if isinstance(buf, (int, float)):
            kin["collision_sphere_buffer"] = float(buf)
    sc = x.get("self_collision", {})
    if sc:
        kin["self_collision_ignore"] = sc.get("ignore", {})
        kin["self_collision_buffer"] = sc.get("buffer_distance", {})
    return {"kinematics": kin}


def build_config(
    urdf_path: str,
    base_link: str,
    tool_frames,
    annex: dict | None = None,
    keep_links=None,
) -> dict:
    robot = urdf_mod.parse_urdf(urdf_path)
    by_child = robot.joint_by_child
    urdf_root = robot.root_link()

    # Floating-base / chain extra links (e.g. unitree_g1's 6-dof virtual
    # base): built BEFORE the URDF subtree, which re-roots under the chain.
    chain_links = []
    reroot_parent = None
    reroot_child = None
    kin_annex = (annex or {}).get("robot_cfg", annex or {}).get("kinematics", {}) if annex else {}
    extra_links = kin_annex.get("extra_links") or {}
    chain_extras = {
        n: e for n, e in extra_links.items()
        if (
            e.get("joint_type", "FIXED").upper() in _TYPED_JOINTS
            and e.get("joint_type", "FIXED").upper() != "FIXED"
        )
        or e.get("child_link_name")
    }
    if chain_extras:
        # topologically order the chain from base_link
        by_parent = {e["parent_link_name"]: (n, e) for n, e in chain_extras.items()}
        cur = base_link
        while cur in by_parent:
            n, e = by_parent[cur]
            jt, axis = _TYPED_JOINTS[e.get("joint_type", "FIXED").upper()]
            ft = e.get("fixed_transform", [0, 0, 0, 1, 0, 0, 0])
            lim = e.get("joint_limits", [-10.0, 10.0])
            vlim = e.get("joint_velocity_limits", [-1.0, 1.0])
            d = {
                "name": e["link_name"],
                "parent": e["parent_link_name"],
                "joint_name": e.get("joint_name", f"{n}_joint"),
                "joint_type": jt,
                "origin_xyz": _floats(ft[:3]),
                "origin_rpy": _floats(_quat_to_rpy(ft)),
            }
            if jt != "fixed":
                d["axis"] = list(axis)
                d["limits"] = [float(lim[0]), float(lim[1]), float(abs(vlim[-1])), 1e6]
            chain_links.append(d)
            if e.get("child_link_name"):
                reroot_parent = e["link_name"]
                reroot_child = e["child_link_name"]
            cur = e["link_name"]

    children = {}
    for j in robot.joints.values():
        children.setdefault(j.parent_link, []).append(j.child_link)
    subtree_root = base_link if base_link in robot.links else urdf_root
    keep = []
    stack = [subtree_root]
    while stack:
        l = stack.pop(0)
        keep.append(l)
        stack.extend(sorted(children.get(l, [])))
    if keep_links is not None:
        keep = [l for l in keep if l in set(keep_links) or l == subtree_root]

    links_out = []
    if chain_links:
        if base_link not in robot.links:
            links_out.append({"name": base_link})
        links_out.extend(chain_links)
    for name in keep:
        link = robot.links[name]
        d = {"name": name}
        if name == reroot_child and reroot_parent is not None:
            # splice the chain: this link's original URDF joint is replaced
            # by a fixed attachment under the floating-base chain end
            d["parent"] = reroot_parent
            d["joint_name"] = f"{name}_root_joint"
            d["joint_type"] = "fixed"
        elif name != subtree_root:
            j = by_child[name]
            if j.parent_link not in keep:
                continue
            d["parent"] = j.parent_link
            d["joint_name"] = j.name
            d["joint_type"] = j.joint_type
            if np.any(np.asarray(j.origin_xyz) != 0):
                d["origin_xyz"] = _floats(j.origin_xyz)
            if np.any(np.asarray(j.origin_rpy) != 0):
                d["origin_rpy"] = _floats(j.origin_rpy)
            if j.joint_type in ("revolute", "continuous", "prismatic"):
                d["axis"] = _floats(j.axis)
                d["limits"] = _floats(
                    [j.limit_lower, j.limit_upper, j.limit_velocity, j.limit_effort]
                )
            if j.mimic_joint:
                d["mimic"] = {
                    "joint": j.mimic_joint,
                    "multiplier": float(j.mimic_multiplier),
                    "offset": float(j.mimic_offset),
                }
        if link.inertial is not None and link.inertial.mass > 0:
            d["mass"] = float(link.inertial.mass)
            d["com"] = _floats(link.inertial.com)
            d["inertia"] = _floats(link.inertial.inertia.reshape(-1))
        if link.visuals:
            vis = []
            for v in link.visuals:
                path = v.mesh
                if path.startswith("package://"):
                    # package://<pkg>/rest -> rest (asset_root = URDF dir,
                    # the conventional package root for shipped URDFs)
                    path = path.split("://", 1)[1].split("/", 1)[-1]
                e = {"mesh": path}
                if np.any(np.asarray(v.xyz) != 0):
                    e["origin_xyz"] = _floats(v.xyz)
                if np.any(np.asarray(v.rpy) != 0):
                    e["origin_rpy"] = _floats(v.rpy)
                if np.any(np.asarray(v.scale) != 1):
                    e["scale"] = _floats(v.scale)
                vis.append(e)
            d["visual"] = vis
        links_out.append(d)

    kept_names = {l["name"] for l in links_out}

    actuated = [
        l["joint_name"]
        for l in links_out
        if l.get("joint_type") in ("revolute", "continuous", "prismatic")
        and "mimic" not in l
    ]

    cfg = {
        "format": "curobo-tpu-robot/1",
        "robot": {
            "name": robot.name,
            "base_link": base_link,
            "tool_frames": list(tool_frames),
            "actuated_joints": actuated,
            # visual-mesh paths resolve against this (override at load
            # with CUROBO_TORCH_ASSET_ROOT); meshes are external assets,
            # not copied into the config
            "asset_root": os.path.dirname(os.path.abspath(urdf_path)),
            "links": links_out,
        },
    }

    if annex:
        kin = annex.get("robot_cfg", annex).get("kinematics", {})
        r = cfg["robot"]
        # Locked joints drop out of the actuated set *before* cspace vectors
        # are remapped, so per-dof vectors line up with the final dof order.
        lock = kin.get("lock_joints") or {}
        if lock:
            r["lock_joints"] = {k: float(v) for k, v in lock.items()}
            actuated = [j for j in actuated if j not in lock]
            r["actuated_joints"] = actuated
        cspace = kin.get("cspace", {})
        if cspace:
            r["cspace"] = {}
            order = cspace.get("joint_names", [])
            # Annex orders cspace vectors by its own joint list; remap to ours.
            def remap(vals):
                if not order or len(vals) != len(order):
                    return [float(v) for v in vals]
                m = dict(zip(order, vals))
                return [float(m[j]) for j in actuated if j in m]

            if "default_joint_position" in cspace:
                full = remap(cspace["default_joint_position"])
                r["cspace"]["retract_config"] = full
            for src, dst in [
                ("max_acceleration", "max_acceleration"),
                ("max_jerk", "max_jerk"),
            ]:
                if src in cspace:
                    v = cspace[src]
                    r["cspace"][dst] = remap(v) if isinstance(v, list) else float(v)
            if "cspace_distance_weight" in cspace:
                r["cspace"]["cspace_weight"] = remap(cspace["cspace_distance_weight"])
            if "null_space_weight" in cspace:
                r["cspace"]["null_space_weight"] = remap(cspace["null_space_weight"])
        col = {}
        spheres = kin.get("collision_spheres") or {}
        spheres = {
            k: [
                {"center": _floats(s["center"]), "radius": float(s["radius"])}
                for s in v
            ]
            for k, v in spheres.items()
            if k in kept_names
        }
        if spheres:
            col["spheres"] = spheres
        ignore = kin.get("self_collision_ignore") or {}
        if ignore:
            col["self_collision_ignore"] = {
                k: list(v) for k, v in ignore.items() if k in kept_names
            }
        buf = kin.get("self_collision_buffer") or {}
        if buf:
            col["self_collision_buffer"] = {
                k: float(v) for k, v in buf.items() if k in kept_names
            }
        if "collision_sphere_buffer" in kin:
            col["sphere_buffer"] = float(kin["collision_sphere_buffer"])
        if col:
            r["collision"] = col
        extra = kin.get("extra_collision_spheres") or {}
        extra_links = kin.get("extra_links") or {}
        chain_names = {d["name"] for d in chain_links}
        if extra_links:
            for name, el in extra_links.items():
                if el.get("link_name", name) in chain_names:
                    continue  # already emitted as floating-base chain
                ft = el.get("fixed_transform", [0, 0, 0, 1, 0, 0, 0])
                # fixed_transform is [x y z qw qx qy qz]; convert quat->rpy.
                from scipy.spatial.transform import Rotation

                rpy = Rotation.from_quat(
                    [ft[4], ft[5], ft[6], ft[3]]
                ).as_euler("xyz")
                r["links"].append(
                    {
                        "name": el.get("link_name", name),
                        "parent": el["parent_link_name"],
                        "joint_name": el.get("joint_name", f"{name}_joint"),
                        "joint_type": el.get("joint_type", "FIXED").lower(),
                        "origin_xyz": _floats(ft[:3]),
                        "origin_rpy": _floats(rpy),
                    }
                )
        if extra:
            r["extra_collision_spheres"] = {k: int(v) for k, v in extra.items()}
    return cfg


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("urdf")
    ap.add_argument("--base-link", required=True)
    ap.add_argument("--tool-frames", required=True)
    ap.add_argument("--annex", default=None)
    ap.add_argument("--out", required=True)
    ap.add_argument("--name", default=None)
    args = ap.parse_args()

    annex = None
    if args.annex:
        with open(args.annex) as f:
            annex = yaml.safe_load(f)
        if isinstance(annex, dict) and annex.get("format") == "xrdf":
            annex = xrdf_to_annex(annex)

    cfg = build_config(
        args.urdf, args.base_link, args.tool_frames.split(","), annex=annex
    )
    if args.name:
        cfg["robot"]["name"] = args.name
    with open(args.out, "w") as f:
        yaml.safe_dump(cfg, f, default_flow_style=None, sort_keys=False)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
