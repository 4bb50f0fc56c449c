// Parallel build of one library from one source (kernels/build.py).
//
// A source that includes this header is compiled once per part p <
// REPRO_PARTS, with -DREPRO_PART=p, every nvcc at once, and the objects are
// linked into the one library. Part p instantiates only the kernels that the
// source deals to it and hands their addresses to part 0 through one extern
// "C" function per part; part 0 also holds the host entry points. Every
// kernel is compiled in exactly one part, as it would be in one translation
// unit (its device functions are all forced inline). Without REPRO_PART (a
// g++ type check, or a single nvcc) one translation unit holds every part.
#pragma once

#define REPRO_PARTS 8
#ifndef REPRO_PART
#define REPRO_PART -1
#endif

// whether this translation unit holds part P
#define REPRO_HOLDS(P) (REPRO_PART < 0 || REPRO_PART == (P))

// X(0) X(1) ... X(REPRO_PARTS - 1)
#define REPRO_FOR_PARTS(X) X(0) X(1) X(2) X(3) X(4) X(5) X(6) X(7)

// a ## b after expanding both (REPRO_CAT(fn_, REPRO_PART) -> fn_3)
#define REPRO_CAT_(a, b) a##b
#define REPRO_CAT(a, b) REPRO_CAT_(a, b)
