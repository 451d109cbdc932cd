"""CUDA kernels a pass launches, counted in the traced passes."""


def read(data):
    if "trace" not in data or not data.get("traced_passes"):
        return None
    return data["trace"].kernels / data["traced_passes"]
