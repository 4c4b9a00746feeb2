"""NumPy oracle: a faithful, bug-for-bug re-implementation of the reference
FpyV step semantics (float64, single drone), the golden trajectory behind
``cli parity``. The port's own copy of ``tools/oracle``, which imports the
JAX package; this one imports the port's config and thrust tables.

Includes every known quirk:
- double attitude rotation per step (kinematics.py:23 + components.py:218)
- position-first semi-implicit Euler (kinematics.py:21-22)
- negated action->rates mapping (components.py:185)
- low-pass memories for rates/thrust (components.py:187-194)
- thrust polynomial with origin sample (flight_time_calculator.py:43-52)
- gyro observation E(rates) with deg/s read as radians (components.py:247)
- crash on SDF<0 at motor points or motor z<0 (components.py:207,239-240)
"""

from fpyv_tpu_torch.oracle.sim import (  # noqa: F401
    OracleCamera,
    OracleCylinder,
    OracleDrone,
    OracleGround,
    OraclePid,
    OracleTarget,
    euler_to_R,
)
