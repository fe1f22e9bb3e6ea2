"""Host-side utilities: WAV, PNG and raw-AVI I/O with numpy and the standard
library only."""
