"""``python -m photorealistic_rendering_using_opencl_tpu_torch``: the CLI
(runtime/app.py); ``--help`` lists its flags."""
import sys

from photorealistic_rendering_using_opencl_tpu_torch.runtime.app import main

if __name__ == "__main__":
    sys.exit(main())
