#!/bin/sh
# Time a parent checkout of the port and this one on the same GPU, in
# turns (parent, change, change, parent), so that the two are compared
# within one machine and one power limit:
#   * chip_smoke.py: each kernel's time against its plain version at
#     32,768 rays, the 1080p frames' walls and the training step's;
#   * scripts/torch_frame_profile.py at one 2**21-ray tile: device time by
#     kernel for the training step (--train) on sponza_standin and for the
#     'pallas' step (--train --pallas: the MT kernel), and for the
#     sponza_standin, final_forest_standin (with and without trees),
#     forest_standin and instanced_grid_standin frames. Both turns run this
#     checkout's profile script (copied into PARENT_DIR), so that they take
#     the same measurements.
#
#   scripts/torch_parent_vs_change.sh PARENT_DIR [OUT_DIR] [cells [NAMES]]
#
# With `cells`, each turn runs instead the benchmark's cells NAMES (default
# its two one-card cells; python -m raytracer_tpu_torch.bench --workload
# NAME: the timed runs and, on one card, the profiled run) and, when NAMES
# holds the training cell, its profile with the backward's gathers by call
# site (torch_frame_profile.py --train --scene sponza_proxy_hd). The
# four-card cell needs a call on four cards.
#
# PARENT_DIR holds the parent commit's files (for example
# `git archive HEAD | tar -x -C _parent` before committing, in a directory
# .gitignore lists). Each command's output goes to
# OUT_DIR/<turn>_<parent|change>_<what>.txt (default chiprun_out/ab); one
# line per command, with its exit code, goes to the standard output.
set -u
parent=$(cd "$1" && pwd)
here=$(cd "$(dirname "$0")/.." && pwd)
out=${2:-$here/chiprun_out/ab}
what=${3:-all}
cells=${4:-sponza_hd_train_1080p final_forest_frame_1080p}
mkdir -p "$out"
out=$(cd "$out" && pwd)
cp "$here/scripts/torch_frame_profile.py" "$parent/scripts/"
turn=0
for tree in "$parent" "$here" "$here" "$parent"; do
  turn=$((turn + 1))
  if [ "$tree" = "$parent" ]; then tag=parent; else tag=change; fi
  cd "$tree" || exit 1
  if [ "$what" = cells ]; then
    for cell in $cells; do
      log="$out/${turn}_${tag}_${cell}.txt"
      python3 -m raytracer_tpu_torch.bench --workload "$cell" > "$log" 2>&1
      echo "$turn $tag bench $cell rc=$?"
    done
    case " $cells " in *" sponza_hd_train_1080p "*)
      log="$out/${turn}_${tag}_train_sites.txt"
      python3 scripts/torch_frame_profile.py --train --scene sponza_proxy_hd \
        --tiles 21 > "$log" 2>&1
      echo "$turn $tag profile train sites rc=$?";;
    esac
    continue
  fi
  log="$out/${turn}_${tag}_smoke.txt"
  python3 chip_smoke.py > "$log" 2>&1
  echo "$turn $tag chip_smoke rc=$?"
  log="$out/${turn}_${tag}_train.txt"
  python3 scripts/torch_frame_profile.py --train --tiles 21 > "$log" 2>&1
  echo "$turn $tag profile train rc=$?"
  log="$out/${turn}_${tag}_train_pallas.txt"
  python3 scripts/torch_frame_profile.py --train --pallas --tiles 21 \
    > "$log" 2>&1
  echo "$turn $tag profile train pallas rc=$?"
  for scene in sponza_standin final_forest_standin \
      final_forest_standin_no_trees forest_standin instanced_grid_standin; do
    log="$out/${turn}_${tag}_${scene}.txt"
    python3 scripts/torch_frame_profile.py --scene "$scene" --tiles 21 \
      > "$log" 2>&1
    echo "$turn $tag profile $scene rc=$?"
  done
done
