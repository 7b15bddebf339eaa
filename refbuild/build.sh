#!/bin/sh
# Build the actual reference FEM binary (its src/ directory, unmodified)
# against the minimal htslib text-SAM stub in htslib_stub/ (the real
# htslib submodule is not vendored). Objects and the binary go to objs/<key>/, where the key
# hashes the sources, the flags and the host CPU's model and feature
# flags, so -march=native code from another machine is never reused.
# Prints the binary's path.
#
# The reference sources are not part of this repository: FEM_REFERENCE_DIR
# must name a checkout of the reference. Without it the script prints why
# on stderr and exits 3, and the differential tests skip with that reason.
set -e
here="$(cd "$(dirname "$0")" && pwd)"
ref="${FEM_REFERENCE_DIR:-}"
if [ -z "$ref" ]; then
    echo "FEM_REFERENCE_DIR is not set (it names a checkout of the reference FEM sources)" >&2
    exit 3
fi
if [ ! -f "$ref/src/FEM.c" ]; then
    echo "FEM_REFERENCE_DIR=$ref holds no src/FEM.c" >&2
    exit 3
fi
CFLAGS="-Wall -O3 -march=native -I$here/htslib_stub/include -I$ref/src"
srcs="sequence_batch.c index.c filter.c align.c input_queue.c output_queue.c map.c FEM_map.c FEM_index.c FEM.c kstring.c"
cpu="$(uname -m) $(grep -m1 '^model name' /proc/cpuinfo 2>/dev/null) $(grep -m1 '^flags' /proc/cpuinfo 2>/dev/null)"
key="$( (echo "$CFLAGS $cpu"; for s in $srcs; do cat "$ref/src/$s"; done;
         cat "$here/htslib_stub/sam_stub.c" "$here/htslib_stub/include/htslib/sam.h") |
        sha256sum | cut -c1-16)"
objs="$here/objs/$key"
out="$objs/FEM"
if [ ! -x "$out" ]; then
    mkdir -p "$objs"
    for s in $srcs; do
        gcc $CFLAGS -c "$ref/src/$s" -o "$objs/${s%.c}.o"
    done
    gcc $CFLAGS -c "$here/htslib_stub/sam_stub.c" -o "$objs/sam_stub.o"
    gcc $CFLAGS "$objs"/*.o -o "$out.tmp$$" -lpthread -lm -lz
    mv "$out.tmp$$" "$out"
fi
echo "$out"
