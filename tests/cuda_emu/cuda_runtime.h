#include "emu.h"
