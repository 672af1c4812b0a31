#!/usr/bin/env bash
# Batch script of the PyTorch port: re-validate trained FAN workflows across
# datasets, as the repository's test_fan_batch.sh does, through
# `python3 -m neural_imaging_tpu_torch.cli.test_fan`. Extra arguments pass
# through (e.g. --patch 64 --device cpu); the runs go on the card unless
# --device cpu is given. Relative paths are taken from the working
# directory, as the root script's are.
set -e
REPO=$(cd "$(dirname "${BASH_SOURCE[0]}")/../.." && pwd)
export PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}"
PYTHON=${PYTHON:-python3}
RUNS_ROOT=${RUNS_ROOT:-"data/m"}
DATASETS=${DATASETS:-"data/raw/training_data/SyntheticCam"}
for run in $(find "$RUNS_ROOT" -name training.json -exec dirname {} \;); do
  for data in $DATASETS; do
    echo "== $run on $data"
    "$PYTHON" -m neural_imaging_tpu_torch.cli.test_fan --run-dir "$run" --data "$data" "$@" || true
  done
done
