#!/bin/bash
# Build and run mul_variants.cu on the card (see its header), then print the
# SASS instruction mix of each loop.  Needs nvcc and cuobjdump (CUDA_HOME,
# default /usr/local/cuda).  Writes its binaries to build/diag/.
set -e
HERE="$(cd "$(dirname "$0")" && pwd)"
OUT="$HERE/../../../build/diag"
CUDA="${CUDA_HOME:-/usr/local/cuda}"
mkdir -p "$OUT"
"$CUDA/bin/nvcc" -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xptxas -v \
  -o "$OUT/mul_variants" "$HERE/mul_variants.cu" 2>&1 | grep -E "Compiling|Used|spill"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
"$OUT/mul_variants"
"$CUDA/bin/nvcc" -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -cubin \
  -o "$OUT/mul_variants.cubin" "$HERE/mul_variants.cu"
"$CUDA/bin/cuobjdump" -sass "$OUT/mul_variants.cubin" > "$OUT/mul_variants.sass"
python3 - "$OUT/mul_variants.sass" <<'PY'
import collections, re, sys
fn, hist = None, collections.defaultdict(collections.Counter)
for line in open(sys.argv[1]):
    m = re.match(r"\s+Function : (\S+)", line)
    if m:
        fn = m.group(1)
        continue
    m = re.match(r"\s+/\*[0-9a-f]+\*/\s+(@!?P\d+\s+)?([A-Z0-9_.]+)", line)
    if m and fn:
        hist[fn][m.group(2)] += 1
for fn, h in hist.items():
    print(fn, "instructions:", sum(h.values()), h.most_common(10))
PY
