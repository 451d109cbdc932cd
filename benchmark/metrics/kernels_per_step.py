"""CUDA kernels an inverse-rendering step launches (forward, backward,
Adam and the clip), counted in the traced step."""


def read(data):
    if "trace" not in data or not data.get("traced_steps"):
        return None
    return data["trace"].kernels / data["traced_steps"]
