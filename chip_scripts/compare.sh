#!/bin/bash
# Parent against change on one card, in one call:
#     bash chip_scripts/compare.sh PARENT_DIR
# runs chip_smoke.py in PARENT_DIR (a `git archive` of the parent commit
# inside the checkout, in a directory .gitignore lists), here, here again
# and in PARENT_DIR again, each log into chiprun_out/{parent1,change1,
# change2,parent2}.log; then the cuda-marked tests here.
parent=${1:?usage: compare.sh PARENT_DIR}
mkdir -p chiprun_out
nvidia-smi --query-gpu=name,power.limit,clocks.max.sm --format=csv,noheader
run() {  # name dir
  local t0=$SECONDS
  (cd "$2" && python3 chip_smoke.py > "$OLDPWD/chiprun_out/$1.log" 2>&1)
  local rc=$?
  echo "$1 rc=$rc seconds=$(( SECONDS - t0 ))"
}
run parent1 "$parent"
run change1 .
run change2 .
run parent2 "$parent"
t0=$SECONDS
JAX_PLATFORMS=cpu python3 -m pytest tests/test_torch_resample_ops.py tests/test_torch_strided_wide.py \
  tests/test_torch_scan.py tests/test_torch_tiled_kernel.py tests/test_torch_strided_wide_kernel.py \
  -q -m cuda -p no:cacheprovider \
  > chiprun_out/cuda_tests.log 2>&1
echo "cuda tests rc=$? seconds=$(( SECONDS - t0 ))"
tail -n 2 chiprun_out/cuda_tests.log
for f in parent1 change1 change2 parent2; do echo "== $f"; tail -n 3 chiprun_out/$f.log | cut -c1-600; done
