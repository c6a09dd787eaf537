#!/bin/sh
# Build the host-side native library into build/native/ (git-ignored).  The
# package also builds it on first use; this runs the same build by hand.
set -e
cd "$(dirname "$0")/.."
python -c "from neutfem_jax import native; print('built', native.build())"
