#!/bin/bash
# The converged-parity runs of docs/parity_port/, started together on one
# CUDA card: 5_0_0 FastEGNN seeds 43-45 (300 epochs), EGNN seeds 43-45 (800),
# VNEGNN seed 43 (800) and 100_0_0 FastEGNN seed 43 (600), each process on
# one CPU thread.  Each dataset without its record draw_<name>.json is
# generated first: 100_0_0 by 7 workers beside the 5_0_0 runs (another draw
# than the JAX package's serial files), 5_0_0 serially (the JAX files)
# before its runs start.  The [best, log] JSONs, each run's output and
# PARITY.md land in OUT; then the checkpoints are removed.
#
#   scripts/torch_parity_runs.sh [OUT]      (default logs/parity_port)
#
# A run cut short goes on with the same command and --resume added.
cd "$(dirname "$0")/.." || exit 1
export OMP_NUM_THREADS=1
OUT=${1:-logs/parity_port}
mkdir -p "$OUT"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python -c "from fastegnn_tpu_torch.ops import _cuda_build; print(sorted(_cuda_build.build()))" || exit 1
start=$(date +%s)
run() {  # name model seed epochs [more arguments]
  local tag=$1_$(echo "$2" | tr A-Z a-z)_s$3
  python scripts/torch_parity_nbody.py --name "$1" --model "$2" --seed "$3" --epochs "$4" \
      --out "$OUT/$tag.json" "${@:5}" > "$OUT/$tag.log" 2>&1
  echo "$tag rc=$? at $(( $(date +%s) - start )) s"
}
run 100_0_0 FastEGNN 43 600 --data data/nbody_parity100 --n_workers 7 &
python -c "import sys; sys.path.insert(0, 'scripts'); import torch_parity_nbody as h; print(h.ensure_dataset(h.DATA, '5_0_0', 1))"
echo "5_0_0 ready at $(( $(date +%s) - start )) s"
for s in 43 44 45; do run 5_0_0 FastEGNN $s 300 & done
for s in 43 44 45; do run 5_0_0 EGNN $s 800 & done
run 5_0_0 VNEGNN 43 800 &
wait
for f in "$OUT"/*_s4?.json; do
  [ -f "$f" ] && rm -rf "${f%.json}_ckpt"
done
python scripts/torch_parity_report.py --dir "$OUT" > /dev/null && grep -a "ratio\|median over" "$OUT/PARITY.md"
