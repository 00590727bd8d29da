"""The cells at a size a CPU test run holds: 32³ voxels (8³ blocks kept as
in the cells, 4 and 32 of them at the block levels), 3 views of 64x80, a
batch of 2, a 4-fragment path.  Widths, dtypes and rules stay the cells'."""
from benchmark.harness import cells


def tiny_cell(name: str) -> cells.Cell:
    c = cells.load_cell(name)
    m = c.config["model_cfgs"]
    m.update(N_VOX=[32, 32, 32], VOXEL_SIZE=0.12, TRAIN_NUM_SAMPLE=[64, 2048, 16384])
    if "GLOBAL_DIMS" in m:
        m["GLOBAL_DIMS"] = [16, 32, 64]
    c.config["batch"] = min(c.config["batch"], 2)
    c.traffic.update(views=3, image_hw=[64, 80], pool_fragments=6, reference_chunk=1,
                     path_fragments=4, scene_m=7.68, spheres=6, path_radius_m=1.2,
                     trace_fragments=2, trace_steps=1)
    return c
