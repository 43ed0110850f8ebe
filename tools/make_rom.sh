#!/bin/bash
# Build the ROM dumper against the reference CommonLib and produce
# vtm_jax/common/rom_tables.npz.
set -e
SRC=/tmp/vtm-src
LIB=$SRC/lib/ninja/gcc-12.2/x86_64/release
g++ -O1 -std=gnu++14 -Wno-deprecated-declarations \
  -I$SRC/source/Lib -I$SRC/source/Lib/CommonLib \
  tools/dump_rom.cpp $LIB/libCommonLib.a $LIB/libUtilities.a -fopenmp \
  -o /tmp/dump_rom
/tmp/dump_rom /tmp/rom.bin
python tools/rom_to_npz.py /tmp/rom.bin vtm_jax/common/rom_tables.npz
