#!/usr/bin/env bash
# Batch script of the PyTorch port: sweep cameras x NIPs x regularization
# strengths for the joint manipulation-classification workflow, as the
# repository's train_manipulation_batch.sh does, through
# `python3 -m neural_imaging_tpu_torch.cli.train_manipulation`. Extra
# arguments pass through (e.g. --data DIR --device cpu); the runs go on the
# card unless --device cpu is given. Relative paths are taken from the
# working directory, as the root script's are.
set -e
REPO=$(cd "$(dirname "${BASH_SOURCE[0]}")/../.." && pwd)
export PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}"
PYTHON=${PYTHON:-python3}
CAMERAS=${CAMERAS:-"SyntheticCam"}
NIPS=${NIPS:-"INet UNet"}
LNS=${LNS:-"0.05 0.1 0.5"}
EPOCHS=${EPOCHS:-1001}
for cam in $CAMERAS; do
  for nip in $NIPS; do
    "$PYTHON" -m neural_imaging_tpu_torch.cli.train_manipulation --cam "$cam" --nip "$nip" \
        --train nip --ln $LNS --jpeg 50 --ds pool --epochs "$EPOCHS" "$@"
  done
done
