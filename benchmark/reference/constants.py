"""Global constants of the LTE cell-search problem.

Values mirror the reference's include/constants.h:32-35 and the compile-time
knobs scattered through src/CellSearch.cpp / src/capbuf.cpp, gathered here in
one typed module.
"""

# LTE "full rate" sample clock. All air-interface timing is defined against
# FS_LTE/16 = 1.92 Msps, which is the capture rate used by this framework.
# (reference: include/constants.h:32)
FS_LTE = 30.72e6

# Capture sample rate used by the search pipeline.
FS_SEARCH = FS_LTE / 16  # 1.92 Msps

# Maximum number of downlink resource blocks (20 MHz). The cell-specific
# reference-signal PN sequence is always generated at this width.
# (reference: include/constants.h:33)
N_RB_MAXDL = 110

# Number of samples captured per center frequency: 80 ms at 1.92 Msps.
# The MIB spans 40 ms at an unknown offset; 80 ms guarantees one full MIB.
# (reference: src/capbuf.cpp:35)
CAPLENGTH = 153600

# Samples per half-frame (5 ms) at 1.92 Msps. PSS repeats on this period.
HALF_FRAME = 9600

# Samples per frame (10 ms) at 1.92 Msps.
FRAME = 19200

# Length of the time-domain PSS correlation template: 128-point IDFT plus a
# 9-sample (normal, symbol>0) cyclic prefix. (reference: src/lte_lib.cpp:187)
PSS_TD_LEN = 137

# Delay-spread combining arm: the PSS correlation is averaged over
# +/- DS_COMB_ARM adjacent lags. (reference: src/CellSearch.cpp:484)
DS_COMB_ARM = 2

# Number of 'nines' in the first detection threshold's false-alarm target:
# P_fa per lag = 10^-THRESH1_N_NINES. (reference: src/CellSearch.cpp:500)
THRESH1_N_NINES = 12

# Second threshold: SSS log-likelihood must exceed mean + N_SIGMA * std of
# all 672 hypotheses. (reference: src/CellSearch.cpp:528)
THRESH2_N_SIGMA = 3.0

# A tracked cell is dropped after this many MIB decode failures.
# (reference: include/constants.h:35)
CELL_DROP_THRESHOLD = 400

# Fraction of the received (oversampled, 1.92 Msps) bandwidth actually
# occupied by a 6-RB LTE downlink: used to scale the noise-power estimate
# entering the chi-squared detection threshold.
# (reference: src/CellSearch.cpp:502)
RX_CUTOFF = (6 * 12 * 15e3 / 2 + 4 * 15e3) / (FS_LTE / 16 / 2)
