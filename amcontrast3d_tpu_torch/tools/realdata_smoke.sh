#!/usr/bin/env bash
# Day-one real-data drill of the port: given an S3DIS root (s3disfull/
# with raw/Area_*.npy rooms), run the production workflow through
# examples/segmentation/main_AA_torch.py with the released YAML as it is:
#
#   1. a short training run  (train → val → checkpoints)
#   2. resume from the latest checkpoint for one more epoch
#   3. the whole-scene voting test (mode=test) from the best checkpoint,
#      with the boundary/inner split and the results CSV
#
# Usage:
#   amcontrast3d_tpu_torch/tools/realdata_smoke.sh <s3dis_root> [out_dir]
#
#   SMOKE_CI=1      shrink the model and the shapes and run each leg with
#                   --device cpu, against fabricated rooms
#                   (tests/test_torch_port_realdata_smoke.py)
#   SMOKE_EPOCHS=N  training epochs before the resume leg (default 2)
#
# On a card with the real dataset, drop SMOKE_CI and raise SMOKE_EPOCHS for
# a real convergence run; the commands are the reference CLI's
# (README.md:61-84).
set -euo pipefail

ROOT=${1:?usage: amcontrast3d_tpu_torch/tools/realdata_smoke.sh <s3dis_root> [out_dir]}
OUT=${2:-${TMPDIR:-/tmp}/amc3d_torch_realdata_smoke_$$}
EPOCHS=${SMOKE_EPOCHS:-2}
REPO=$(cd "$(dirname "$0")/../.." && pwd)
CFG="cfgs/s3dis/AMContrast3D-AA.yaml"
MAIN="examples/segmentation/main_AA_torch.py"
cd "$REPO"

DEVICE=()
COMMON=("dataset.common.data_root=$ROOT" "root_dir=$OUT" "seed=0"
        "val_freq=1" "wandb.use_wandb=False")
if [[ "${SMOKE_CI:-0}" != "0" ]]; then
  # a CPU-sized drill: a tiny model, tiny crops, one pass of the rooms an
  # epoch; the code paths are the production ones, only the shapes shrink
  DEVICE=(--device cpu)
  COMMON+=("batch_size=2" "val_batch_size=1" "eval_bucket=512"
           "dataset.train.voxel_max=256" "dataset.train.loop=1"
           "dataset.val.voxel_max=512" "dataset.val.presample=False"
           "model.encoder_args.width=8" "model.encoder_args.blocks=[1,1,1]"
           "model.encoder_args.strides=[1,4,4]"
           "model.encoder_args.nsample=8"
           "model.decoder_args.decoder_stages=2"
           "ambiguity_args.stages_num=2" "ambiguity_args.nsample=8")
fi

echo "== [1/3] train ($EPOCHS epochs) =="
python "$MAIN" "${DEVICE[@]}" --cfg "$CFG" "epochs=$EPOCHS" "${COMMON[@]}"

LATEST=$(find "$OUT" -name '*latest*.ckpt' | head -1)
[[ -n "$LATEST" ]] || { echo "no latest checkpoint under $OUT"; exit 1; }
echo "== [2/3] resume from $LATEST =="
python "$MAIN" "${DEVICE[@]}" --cfg "$CFG" mode=resume \
  "pretrained_path=$LATEST" "epochs=$((EPOCHS + 1))" "${COMMON[@]}"

BEST=$(find "$OUT" -name '*best*.ckpt' | head -1)
[[ -n "$BEST" ]] || { echo "no best checkpoint under $OUT"; exit 1; }
echo "== [3/3] whole-scene test from $BEST =="
python "$MAIN" "${DEVICE[@]}" --cfg "$CFG" mode=test \
  "pretrained_path=$BEST" "ambiguity_args.miou_B_I=True" "${COMMON[@]}"

CSV=$(find "$OUT" -name '*_test.csv' | head -1)
[[ -n "$CSV" ]] || { echo "no results CSV under $OUT"; exit 1; }
echo "== drill complete: results CSV at $CSV =="
cat "$CSV"
