#pragma once
// cooperative_groups for the CPU emulation: its stand-ins live in the
// emulated runtime.
#include "cuda_runtime.h"
