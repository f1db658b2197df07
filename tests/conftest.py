import os

# Tests run on a virtual 8-device CPU mesh, so multi-device code paths are
# tested without a cluster (SURVEY.md §4).  Must be set before jax
# initialises.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import sys

sys.path.insert(0, os.path.dirname(__file__))

# NOTE: do NOT enable the persistent compilation cache here — with worlds
# whose optional index-table fields differ in None-ness it has been observed
# to serve an executable with a mismatched buffer count ("supplied 49
# buffers but compiled program expected 51").
