#!/bin/sh
# Build the native host parser -> go_mp3_tpu/native/libmp3parse.so
#
# Plain -O3, no PGO: profile-guided builds were measured (round 5, on the
# project's earlier single-core development host, not the GPU machine's
# host) at 3-8% SLOWER than plain -O3 on the production corpus-parse workload
# (interleaved same-process A/B, both with the legacy mixed-entry-point
# trainer and with a trainer driving gmp_parse_packed8_many on the exact
# bench corpus). GCC's profile-driven block layout pessimizes the
# multi-symbol Huffman drain loop; earlier +5-7% PGO readings predate the
# round-4 interleaved-lane/many-call loop shape. Do not re-enable without
# a fresh interleaved A/B win.
set -e
cd "$(dirname "$0")/.."

SRC="go_mp3_tpu/native/mp3parse.cpp go_mp3_tpu/native/mp3dsp.cpp \
     go_mp3_tpu/native/synth_window_data.cpp"
OUT="go_mp3_tpu/native/libmp3parse.so"
# -ffp-contract=off: the exact DSP replicates the Go reference's float32
# arithmetic, and Go's amd64 backend never contracts mul+add into FMA —
# letting g++ fuse changes ~200 samples/file by 1 LSB.
FLAGS="-O3 -march=native -ffp-contract=off -std=c++17 -fPIC -shared -Wall -Wextra"

g++ $FLAGS $SRC -o "$OUT"
echo "built $OUT"
