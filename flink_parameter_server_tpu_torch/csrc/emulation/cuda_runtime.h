// Stand-in for the CUDA header under the CPU emulation (cuda_emu.h).
#pragma once
#include "cuda_emu.h"
