#!/bin/bash
# The Water-3D matched converged-parity runs of docs/parity_port/, started
# together on one CUDA card: FastEGNN seeds 43-47 for EPOCHS epochs each
# (scripts/torch_parity_simulation.py on the committed protocol), each
# process on one CPU thread, after one build of the kernels.  The
# [best, log] JSONs and each run's output land in OUT, with PARITY.md
# judged against the JAX JSONs in docs/parity_port/; then each finished
# run's checkpoint and live log are removed.  With jax-init as the third
# argument each seed starts from the JAX harness's init of the same seed
# (--init docs/parity_port/water3d_jax_init_s<seed>.npz) and writes
# water3d_fastegnn_jaxinit_s<seed>.json.
#
#   scripts/torch_parity_water3d_runs.sh [OUT] [EPOCHS] [jax-init]   (default logs/parity_port, 700)
#
# A run cut short goes on with its harness command and --resume added.
cd "$(dirname "$0")/.." || exit 1
export OMP_NUM_THREADS=1
OUT=${1:-logs/parity_port}
EPOCHS=${2:-700}
NAME=water3d_fastegnn
[ "$3" = jax-init ] && NAME=water3d_fastegnn_jaxinit
mkdir -p "$OUT"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python -c "from fastegnn_tpu_torch.ops import _cuda_build; print(sorted(_cuda_build.build()))" || exit 1
start=$(date +%s)
for s in 43 44 45 46 47; do
  init=()
  [ "$3" = jax-init ] && init=(--init "docs/parity_port/water3d_jax_init_s$s.npz")
  (python scripts/torch_parity_simulation.py --seed $s --epochs "$EPOCHS" "${init[@]}" \
       --out "$OUT/${NAME}_s$s.json" > "$OUT/${NAME}_s$s.log" 2>&1
   echo "${NAME}_s$s rc=$? at $(( $(date +%s) - start )) s") &
done
wait
for f in "$OUT"/${NAME}_s4?.json; do
  [ -f "$f" ] && rm -rf "${f%.json}_ckpt" "${f%.json}_live.json"
done
python scripts/torch_parity_report.py --dir "$OUT" --seeds_jax_dir docs/parity_port > /dev/null \
  && sed -n '/^## Water-3D/,/^## Protein/p' "$OUT/PARITY.md" | grep -a "^- (a)\|^- (b)\|^- port from the JAX inits"
