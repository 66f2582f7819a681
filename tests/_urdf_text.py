"""URDF text for the URDF, builder and optimizer tests of both packages: the
chain of a robot YAML's `links` (origins, axes, limits, mimic relations,
inertials, visuals) written as a URDF, and small chains written by hand. The
repository ships no URDF, so the tests write their own."""

import numpy as np


def _v(x):
    return " ".join(repr(float(a)) for a in x)


def urdf_of_robot_yaml(d: dict) -> str:
    """URDF text of a robot YAML dict's `links`; visual meshes are named
    ``package://robot/<mesh>``, as a description package would."""
    r = d["robot"] if "robot" in d else d
    out = ['<?xml version="1.0"?>', f'<robot name="{r.get("name", "robot")}">']
    for l in r["links"]:
        out.append(f'  <link name="{l["name"]}">')
        if "mass" in l:
            I = np.asarray(l.get("inertia", [0.0] * 9), np.float64).reshape(3, 3)
            out += ["    <inertial>",
                    f'      <origin xyz="{_v(l.get("com", (0, 0, 0)))}" rpy="0 0 0"/>',
                    f'      <mass value="{float(l["mass"])!r}"/>',
                    f'      <inertia ixx="{float(I[0, 0])!r}" ixy="{float(I[0, 1])!r}" '
                    f'ixz="{float(I[0, 2])!r}" iyy="{float(I[1, 1])!r}" '
                    f'iyz="{float(I[1, 2])!r}" izz="{float(I[2, 2])!r}"/>',
                    "    </inertial>"]
        for v in l.get("visual", []):
            out += ["    <visual>",
                    f'      <origin xyz="{_v(v.get("origin_xyz", (0, 0, 0)))}" '
                    f'rpy="{_v(v.get("origin_rpy", (0, 0, 0)))}"/>',
                    f'      <geometry><mesh filename="package://robot/{v["mesh"]}" '
                    f'scale="{_v(v.get("scale", (1, 1, 1)))}"/></geometry>',
                    "    </visual>"]
        out.append("  </link>")
    for l in r["links"]:
        if l.get("parent") is None:
            continue
        jt = l.get("joint_type", "fixed")
        out += [f'  <joint name="{l.get("joint_name", l["name"] + "_joint")}" type="{jt}">',
                f'    <parent link="{l["parent"]}"/>', f'    <child link="{l["name"]}"/>',
                f'    <origin xyz="{_v(l.get("origin_xyz", (0, 0, 0)))}" '
                f'rpy="{_v(l.get("origin_rpy", (0, 0, 0)))}"/>']
        # every joint's axis, the fixed ones' too: the YAML's default is z
        out.append(f'    <axis xyz="{_v(l.get("axis", (0, 0, 1)))}"/>')
        if jt != "fixed":
            lo, hi, vel, eff = l["limits"]
            out += [f'    <limit lower="{float(lo)!r}" upper="{float(hi)!r}" '
                    f'velocity="{float(vel)!r}" effort="{float(eff)!r}"/>']
        if l.get("mimic"):
            m = l["mimic"]
            out.append(f'    <mimic joint="{m["joint"]}" '
                       f'multiplier="{float(m.get("multiplier", 1.0))!r}" '
                       f'offset="{float(m.get("offset", 0.0))!r}"/>')
        out.append("  </joint>")
    out.append("</robot>")
    return "\n".join(out) + "\n"


# A chain with prismatic, fixed and continuous joints, a rotated inertial and
# a rotated visual with a scale, a joint without an axis (URDF default x) and
# a second branch off the base.
MIXED_URDF = """<?xml version="1.0"?>
<robot name="mixed_chain">
  <link name="base">
    <inertial><origin xyz="0 0 0.05" rpy="0 0 0"/><mass value="4.0"/>
      <inertia ixx="0.02" ixy="0" ixz="0" iyy="0.02" iyz="0" izz="0.01"/></inertial>
  </link>
  <link name="slider">
    <inertial><origin xyz="0.01 0.02 0.03" rpy="0.3 -0.2 0.5"/><mass value="1.5"/>
      <inertia ixx="0.004" ixy="0.0002" ixz="-0.0001" iyy="0.005" iyz="0.0003" izz="0.003"/>
    </inertial>
    <visual><origin xyz="0 0 0.1" rpy="0 0.5 0"/>
      <geometry><mesh filename="package://mixed/meshes/slider.stl" scale="0.001 0.001 0.001"/></geometry>
    </visual>
  </link>
  <link name="bracket"/>
  <link name="spinner">
    <inertial><origin xyz="0 0 0.02"/><mass value="0.7"/>
      <inertia ixx="0.001" ixy="0" ixz="0" iyy="0.001" iyz="0" izz="0.0005"/></inertial>
  </link>
  <link name="elbow"/>
  <link name="tool"/>
  <link name="camera"/>
  <joint name="lift" type="prismatic">
    <parent link="base"/><child link="slider"/>
    <origin xyz="0 0 0.2" rpy="0 0 0.3"/><axis xyz="0 0 2"/>
    <limit lower="0.0" upper="0.5" velocity="0.3" effort="200"/>
  </joint>
  <joint name="mount" type="fixed">
    <parent link="slider"/><child link="bracket"/>
    <origin xyz="0.1 0 0.05" rpy="1.5707963 0 0"/>
  </joint>
  <joint name="spin" type="continuous">
    <parent link="bracket"/><child link="spinner"/>
    <origin xyz="0 0.05 0"/><axis xyz="0 1 0"/>
  </joint>
  <joint name="bend" type="revolute">
    <parent link="spinner"/><child link="elbow"/>
    <origin xyz="0 0 0.3" rpy="0 -0.4 0"/>
    <limit lower="-1.5" upper="1.2" velocity="1.0" effort="30"/>
  </joint>
  <joint name="flange" type="fixed">
    <parent link="elbow"/><child link="tool"/>
    <origin xyz="0.2 0 0"/>
  </joint>
  <joint name="camera_joint" type="fixed">
    <parent link="base"/><child link="camera"/>
    <origin xyz="0.3 0 0.6" rpy="0 0.7 0"/>
  </joint>
</robot>
"""
