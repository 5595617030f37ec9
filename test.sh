#!/bin/bash
# Run the test suite on the local CPU backend with a virtual 8-device mesh.
export JAX_PLATFORMS=cpu
export XLA_FLAGS="--xla_force_host_platform_device_count=8 ${XLA_FLAGS:-}"
exec python -m pytest "${@:-tests/}" -q
