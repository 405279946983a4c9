"""Native (C) host-runtime helper, built from the port's copy of the JAX
package's source (`_fastio.c`)."""

from .build import build, load  # noqa: F401
