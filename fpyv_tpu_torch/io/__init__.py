"""Host-side IO: config files, motor test CSVs and flight logs (the port's
own copies of ``fpyv_tpu.io.files``, ``motor_csv``, ``logs`` and
``blackbox_native``)."""

from fpyv_tpu_torch.io.files import json_reader, json_writer, yaml_reader, yaml_writer  # noqa: F401
from fpyv_tpu_torch.io.motor_csv import read_motor_test_report  # noqa: F401
