#!/bin/bash
# The SASS of the kernels that include the shared headers (msda_bwd.cu,
# msda_stream.cu, msda_auction.cu), built from an earlier tree's csrc and
# from the checkout's, compared instruction by instruction (the mangled
# names, which carry a hash of the file, left out): a helper moved into a
# shared header must leave them as they were.  On a machine with nvcc:
#
#   git archive cc78811 msda_tpu_torch | tar -x -C build/ab_parent
#   bash docs/experiments/torch_sass_identity.sh build/ab_parent/msda_tpu_torch/csrc
#
# Writes the listings under build/sass/; exits non-zero if one differs.
set -eu
parent=$1
out=build/sass
mkdir -p "$out"
nvcc=${CUDA_HOME:-/usr/local/cuda}/bin/nvcc
objdump=${CUDA_HOME:-/usr/local/cuda}/bin/cuobjdump
status=0
for f in msda_bwd msda_stream msda_auction; do
  for side in old new; do
    src=$([ $side = old ] && echo "$parent" || echo msda_tpu_torch/csrc)/$f.cu
    "$nvcc" -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -cubin \
      -o "$out/$f.$side.cubin" "$src"
    "$objdump" -sass "$out/$f.$side.cubin" | grep -v "Function :" \
      > "$out/$f.$side.sass"
  done
  if cmp -s "$out/$f.old.sass" "$out/$f.new.sass"; then
    echo "$f: SASS identical ($(wc -l < "$out/$f.new.sass") lines)"
  else
    echo "$f: SASS DIFFERS"
    status=1
  fi
done
exit $status
