"""The BVH walk W1's share of its roofline in the traced passes, %: the
least time its bytes need at the H100's published HBM rate (the scene's
triangles read once a launch, each walked ray's inputs read once and its
hit written once: harness/roofline.py) over the device time of every
``bvh_walk_kernel`` launch.  None where W1 did not run."""
from benchmark.harness.roofline import least_seconds, w1_bytes


def read(data):
    if "trace" not in data or not data.get("w1_launches"):
        return None
    busy = data["trace"].kernel_seconds("bvh_walk_kernel")
    if busy <= 0.0:
        return None
    need = w1_bytes(data["n_triangles"], data["w1_launches"], data["w1_rays"])
    return 100.0 * least_seconds(need) / busy
