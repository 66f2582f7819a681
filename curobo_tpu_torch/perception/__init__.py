"""Perception: depth and LiDAR observations -> TSDF maps (dense grid or
block-sparse pool) -> ESDF voxel grids for the planning world, with depth
filtering, robot segmentation, raycast rendering, camera pose refinement,
object pose estimation and mesh extraction."""
