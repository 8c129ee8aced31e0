"""Device/runtime introspection and process set-up.

Parity with spECK::spECKConfig (/root/reference/include/spECKConfig.h:8-53),
which queries SM count and shared-memory limits and allocates 6 streams +
4 timing events. Under JAX, XLA owns streams and events (timing is
wall-clock around ``jax.block_until_ready``), so the equivalent is a
snapshot of the device topology and the device-memory budget the planner
tunes against.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
from typing import Optional

import jax

# the checkout root (speck_tpu/utils/ -> two levels up)
_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
COMPILE_CACHE_DIR = os.path.join(_CHECKOUT, ".jax_cache")


def enable_compile_cache() -> Optional[str]:
    """Turn on JAX's persistent compilation cache for a program entry
    point (CLI, bench, chip smoke). When ``JAX_COMPILATION_CACHE_DIR`` is
    set, JAX already reads it and nothing is set here. Otherwise the
    cache lives at the fixed ``<checkout>/.jax_cache``: the path is part
    of the cache key, so it must not vary between runs. Returns the
    directory set in code, or None."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    jax.config.update("jax_compilation_cache_dir", COMPILE_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return COMPILE_CACHE_DIR


def gpu_card_line() -> Optional[str]:
    """The card's name and power limit as nvidia-smi reports them
    (``name, power.limit`` per card, one line each), or None when
    nvidia-smi is unavailable. Power limit matters for every timing: a
    card capped below its maximum runs slower under load."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    out = r.stdout.strip()
    return out if r.returncode == 0 and out else None


@dataclasses.dataclass(frozen=True)
class DeviceInfo:
    platform: str
    device_kind: str
    num_devices: int
    num_local_devices: int
    hbm_bytes: Optional[int]

    @classmethod
    def current(cls) -> "DeviceInfo":
        devs = jax.devices()
        d = devs[0]
        stats = None
        try:
            ms = d.memory_stats()
            stats = ms.get("bytes_limit") if ms else None
        except Exception:
            pass
        return cls(
            platform=d.platform,
            device_kind=getattr(d, "device_kind", "unknown"),
            num_devices=len(devs),
            num_local_devices=len(jax.local_devices()),
            hbm_bytes=stats,
        )

    def summary(self) -> str:
        mem = f"{self.hbm_bytes / 2**30:.1f} GiB" if self.hbm_bytes else "?"
        s = (
            f"{self.device_kind} ({self.platform}), "
            f"{self.num_devices} device(s) "
            f"({self.num_local_devices} local), device memory {mem}"
        )
        if self.platform == "gpu":
            card = gpu_card_line()
            s += f"; card: {card.splitlines()[0] if card else 'unknown'}"
        return s


def device_info() -> DeviceInfo:
    return DeviceInfo.current()
