#!/bin/bash
# The protein converged-parity runs of docs/parity_port/, started together
# on one CUDA card: FastEGNN seeds 43-47 for EPOCHS epochs each, or to
# early stop (scripts/torch_parity_protein.py on the committed synthetic
# AdK chain), each process on one CPU thread, after one build of the
# kernels.  The [best, log] JSONs and each run's output land in OUT, with
# PARITY.md judged against the JAX JSONs in docs/parity_port/
# (scripts/parity_protein_jax.py); then each finished run's checkpoint and
# live log are removed.
#
#   scripts/torch_parity_protein_runs.sh [OUT] [EPOCHS]   (default logs/parity_port, 150)
#
# A run cut short goes on with its harness command and --resume added.
cd "$(dirname "$0")/.." || exit 1
export OMP_NUM_THREADS=1
OUT=${1:-logs/parity_port}
EPOCHS=${2:-150}
mkdir -p "$OUT"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python -c "from fastegnn_tpu_torch.ops import _cuda_build; print(sorted(_cuda_build.build()))" || exit 1
start=$(date +%s)
for s in 43 44 45 46 47; do
  (python scripts/torch_parity_protein.py --seed $s --epochs "$EPOCHS" \
       --out "$OUT/protein_fastegnn_s$s.json" > "$OUT/protein_fastegnn_s$s.log" 2>&1
   echo "protein_fastegnn_s$s rc=$? at $(( $(date +%s) - start )) s") &
done
wait
for f in "$OUT"/protein_fastegnn_s4?.json; do
  [ -f "$f" ] && rm -rf "${f%.json}_ckpt" "${f%.json}_live.json"
done
python scripts/torch_parity_report.py --dir "$OUT" --seeds_jax_dir docs/parity_port > /dev/null \
  && sed -n '/^## Protein/,$p' "$OUT/PARITY.md" | grep -a "^- (a)\|^- (b)"
