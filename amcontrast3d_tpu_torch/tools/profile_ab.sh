#!/bin/sh
# Two commits against each other on one card, inside one run.
#
# Medians of the same code move by 1-3 % between runs on different
# machines or power limits, so a parent and a change are compared only
# side by side.  From the root of the change's checkout:
#
#   mkdir -p _parent && git archive <parent commit> | tar -x -C _parent
#   sh amcontrast3d_tpu_torch/tools/profile_ab.sh [profiler arguments]
#
# runs the eval profiler and then the train profiler, each in the order
# parent, change, change, parent (so a drift of the card shows as a
# difference between the two readings of one commit), and prints each
# profiler's whole output under a "=== parent|change: <tool>" heading.
# The arguments (say --kind mm) go to both profilers of both checkouts,
# so pass only what the parent understands.  AB_TOOLS names other tools
# (say AB_TOOLS="profile_scans profile_train"); a tool the parent does not
# have, or whose file in the change's tree holds the line
# "AB_BOTH_PACKAGES = True" (it reads only what both packages have), runs
# from the change's tree over the parent's package.  AB_PARENT names
# another tree to take the parent's place (say a variant of the change
# under _parent/variant).  _parent/ is git-ignored; each checkout builds its
# own kernels.
set -eu
root=$(pwd)
parent=$root/${AB_PARENT:-_parent}
[ -d "$parent/amcontrast3d_tpu_torch" ] || {
    echo "profile_ab: unpack the parent commit into $parent first" >&2
    exit 2
}
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
for tool in ${AB_TOOLS:-profile_eval profile_train}; do
    for side in parent change change parent; do
        [ "$side" = parent ] && dir="$parent" || dir="$root"
        echo "=== $side: $tool $*"
        mine="$root/amcontrast3d_tpu_torch/tools/$tool.py"
        if [ -f "$dir/amcontrast3d_tpu_torch/tools/$tool.py" ] &&
            ! grep -q '^AB_BOTH_PACKAGES = True' "$mine" 2>/dev/null; then
            (cd "$dir" && python3 -m "amcontrast3d_tpu_torch.tools.$tool" "$@")
        else
            (cd "$dir" && PYTHONPATH="$dir" python3 "$mine" "$@")
        fi
    done
done
