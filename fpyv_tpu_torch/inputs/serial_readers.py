"""Hardware-in-the-loop serial protocol parsers.

The reference's HW experiment scripts bundle protocol parsing with
matplotlib loops (tests/read_gyroglove.py, read_rx5808.py,
read_timing_system_data_log_live.py, read_velocidrone_tracks.py). Here the
parsers are pure, unit-testable functions over text buffers, and the
streaming loops are thin optional wrappers gated on pyserial.

Protocols (semantics per the reference scripts):

- **Gyroglove IMU** (read_gyroglove.py): ASCII lines carrying
  ``quaternion: w: N, x: N, y: N, z: N``, ``Rotation matrix: r11 .. r33``,
  ``Position: x y z``, ``Acceleration: x y z`` — integer values scaled by
  1/16384. The stream may cut lines mid-write, so parsers take the
  second-to-last candidate when the last is incomplete (:count_elements
  logic).
- **RX5808 RSSI scanner** (read_rx5808.py): lines
  ``Frequency: NNNN MHz, RSSI: NNN dBm`` sweeping the 40-channel 5.8 GHz
  band table.
- **Lap-timing beacons** (read_timing_system_data_log_live.py): 27-char
  frames ``$`` + 10-digit timestamp + 12-hex MAC + 2-digit RSSI + 2-hex
  XOR CRC over the 24 data chars.
- **Velocidrone tracks** (read_velocidrone_tracks.py): base64-encoded .trk
  files.

The port's own copy of ``fpyv_tpu.inputs.serial_readers``.
"""

from __future__ import annotations

import base64
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

IMU_SCALE = 16384.0

# 5.8 GHz band table (read_rx5808.py:24-29): bands A, B, E, F(airwave), R(race)
RX5808_FREQS = (
    5865, 5845, 5825, 5805, 5785, 5765, 5745, 5725,
    5733, 5752, 5771, 5790, 5809, 5828, 5847, 5866,
    5705, 5685, 5665, 5645, 5885, 5905, 5925, 5945,
    5740, 5760, 5780, 5800, 5820, 5840, 5860, 5880,
    5658, 5695, 5732, 5769, 5806, 5843, 5880, 5917,
)


# ---------------------------------------------------------------------------
# Gyroglove IMU text stream
# ---------------------------------------------------------------------------


def _complete_candidate(lines: List[str], expected: int) -> Optional[str]:
    """Last line if it parses to `expected` numbers, else second-to-last
    (read_gyroglove.py count_elements_in_str_line + selection logic)."""
    if len(lines) < 2:
        return None
    tail = lines[-1].split(":")[-1].split()
    n = len(tail)
    if n and not _is_float(tail[-1]):
        n -= 1
    return lines[-1] if n == expected else lines[-2]


def _is_float(s: str) -> bool:
    try:
        float(s)
        return True
    except ValueError:
        return False


@dataclass
class GyrogloveSample:
    quaternion: Optional[np.ndarray] = None  # (4,) w,x,y,z
    rotation_matrix: Optional[np.ndarray] = None  # (3, 3)
    position: Optional[np.ndarray] = None  # (3,)
    acceleration: Optional[np.ndarray] = None  # (3,)


def parse_gyroglove(text: str) -> GyrogloveSample:
    """Parse the newest complete IMU sample out of a raw text buffer."""
    lines = text.split("\r\n")
    out = GyrogloveSample()

    pos = [l for l in lines if "Position" in l]
    cand = _complete_candidate(pos, 3)
    if cand is not None:
        vals = cand.replace("Position: ", "").split()
        if len(vals) == 3 and all(_is_float(v) for v in vals):
            out.position = np.array([float(v) for v in vals]) / IMU_SCALE

    acc = [l for l in lines if "Acceleration" in l]
    cand = _complete_candidate(acc, 3)
    if cand is not None:
        vals = cand.replace("Acceleration: ", "").split()
        if len(vals) == 3 and all(_is_float(v) for v in vals):
            out.acceleration = np.array([float(v) for v in vals]) / IMU_SCALE

    quat = [l for l in lines if "quaternion" in l]
    cand = _complete_candidate(quat, 4)
    if cand is not None:
        body = cand.replace("quaternion: ", "")
        try:
            q = np.array([float(x.split(": ")[-1]) for x in body.split(",")])
            if len(q) == 4:
                out.quaternion = q / IMU_SCALE
        except ValueError:
            pass

    rotm = [l for l in lines if "Rotation matrix" in l]
    cand = _complete_candidate(rotm, 9)
    if cand is not None:
        vals = cand.replace("Rotation matrix: ", "").split()
        if len(vals) == 9 and all(_is_float(v) for v in vals):
            out.rotation_matrix = (
                np.array([float(v) for v in vals]).reshape(3, 3) / IMU_SCALE)
    return out


# ---------------------------------------------------------------------------
# RX5808 RSSI spectrum
# ---------------------------------------------------------------------------


def parse_rx5808(text: str) -> Dict[int, int]:
    """{frequency MHz: RSSI} from 'Frequency: N MHz, RSSI: N dBm' lines
    (read_rx5808.py:44-56; the trailing partial line is dropped)."""
    lines = [l.split("\r")[0] for l in text.split("\r\n") if "Frequency: " in l][:-1]
    out: Dict[int, int] = {}
    for l in lines:
        try:
            freq = int(l.split(" MHz,")[0].split("Frequency: ")[-1])
            rssi = int(l.split(" dBm")[0].split("RSSI: ")[-1])
            out[freq] = rssi
        except (ValueError, IndexError):
            continue
    return out


# ---------------------------------------------------------------------------
# Lap-timing beacon frames
# ---------------------------------------------------------------------------


def timing_crc(data: str) -> int:
    """XOR of character codes (read_timing_system_data_log_live.py:11-15)."""
    crc = 0
    for ch in data:
        crc ^= ord(ch)
    return crc


def parse_timing_message(message: str) -> Optional[Tuple[int, str, int]]:
    """'$' + 10-digit timestamp + 12-hex MAC + 2-digit RSSI + 2-hex CRC ->
    (timestamp, 'aa:bb:cc:dd:ee:ff', -rssi); None on any integrity failure
    (read_timing_system_data_log_live.py:17-39)."""
    if len(message) != 27 or message[0] != "$":
        return None
    data = message[1:25]
    try:
        crc_received = int(message[25:], 16)
    except ValueError:
        return None
    if timing_crc(data) != crc_received:
        return None
    try:
        timestamp = int(data[0:10])
        rssi = -int(data[22:])
    except ValueError:
        return None
    mac = ":".join(data[i:i + 2] for i in range(10, 22, 2))
    return timestamp, mac, rssi


def make_timing_message(timestamp: int, mac: str, rssi: int) -> str:
    """Inverse of parse_timing_message (for tests / simulated beacons)."""
    data = f"{timestamp:010d}{mac.replace(':', '')}{abs(rssi):02d}"
    assert len(data) == 24, data
    return f"${data}{timing_crc(data):02X}"


def parse_timing_stream(text: str) -> List[Tuple[int, str, int]]:
    out = []
    for entry in text.split("\r\n"):
        if entry.startswith("$") and len(entry) == 27:
            parsed = parse_timing_message(entry)
            if parsed is not None:
                out.append(parsed)
    return out


# ---------------------------------------------------------------------------
# Velocidrone track files
# ---------------------------------------------------------------------------


def read_velocidrone_track(path) -> bytes:
    """Decode a base64 .trk file (read_velocidrone_tracks.py:3-8)."""
    with open(path, "r") as f:
        return base64.b64decode(f.read())


# ---------------------------------------------------------------------------
# Streaming wrapper (optional pyserial)
# ---------------------------------------------------------------------------


def stream_serial(port: str, parser, baud: int = 115200, max_reads: int = 0):
    """Generator yielding parser(text_buffer) per poll; requires pyserial."""
    import serial  # gated

    ser = serial.Serial(port, baud, timeout=0.001)
    try:
        buffer: List[str] = []
        reads = 0
        while max_reads == 0 or reads < max_reads:
            waiting = ser.in_waiting
            buffer += [chr(c) for c in ser.read(waiting)]
            yield parser("".join(buffer))
            reads += 1
    finally:
        ser.close()
