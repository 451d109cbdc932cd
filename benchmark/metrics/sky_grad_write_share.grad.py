"""The share of the sky lookups' taps whose gradient reaches the map as a
write of its own: the program's ``sky_grad.writes`` (the texel writes the
sky map's gradient kernel made, 4 a lane whose gradient is not zero)
over ``sky_grad.taps`` (4 a lane of each backward), in the traced step.  A program without the
kernel counts neither and reads None."""
from benchmark.harness.spans import share


def read(data):
    if "trace" not in data:
        return None
    return share("sky_grad.writes", "sky_grad.taps")
