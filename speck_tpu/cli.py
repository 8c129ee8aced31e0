"""runspeck — benchmark CLI, the analogue of runspECK
(/root/reference/source/runspECK.cpp:13-32 + source/RunConfig.cpp:8-23).

Usage: runspeck <matrix.mtx> [config.ini] [--fp64]

Config keys honored (the reference's 6 live keys, SURVEY.md section 2 #4):
InputFile, IterationsWarmUp, IterationsExecution, TrackIndividualTimes,
TrackCompleteTimes, CompareResult.
"""

from __future__ import annotations

import sys

import numpy as np


def main(argv=None):
    argv = list(sys.argv if argv is None else argv)
    from .executor import Executor
    from .utils.config import Config
    from .utils.device import device_info, enable_compile_cache

    args = [a for a in argv[1:] if not a.startswith("--")]
    # a lone config file still works when it supplies InputFile; flag-only
    # invocations (e.g. `runspeck --fp64`) get the usage error, not a crash
    config = Config.init(args[1] if len(args) > 1 else None)
    if len(args) == 1 and args[0].endswith(".ini"):
        config = Config.init(args[0])
        args = []
    # InputFile in the config overrides the command line (RunConfig.cpp:22)
    if "--fp64" in argv:
        # real double precision end to end: without x64, JAX silently
        # downcasts device arrays to f32 (reference: double instantiation,
        # Multiply.cu:1130-1131)
        import jax

        jax.config.update("jax_enable_x64", True)
    path = config.get_string("InputFile", "") or (args[0] if args else "")
    if not path:
        print(
            "Need matrix market file path (.mtx) as first argument\n"
            "Usage: runspeck <matrix.mtx> [config.ini] [--fp64]",
            file=sys.stderr,
        )
        return 1
    dtype = np.float64 if "--fp64" in argv else np.float32
    enable_compile_cache()
    print(f"device: {device_info().summary()}")
    executor = Executor(path, config=config, dtype=dtype)
    result = executor.run()
    return 0 if result.compared_ok in (None, True) else 2


if __name__ == "__main__":
    sys.exit(main())
