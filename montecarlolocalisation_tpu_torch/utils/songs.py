"""Audible feedback: the reference's song library as data + event mapping
+ the iRobot Create serial transport (opcode encoder).

Torch-port copy of montecarlolocalisation_tpu/utils/songs.py (plain
Python).

Reference: src/songs_lib.cpp + include/package/songs_lib.hpp.  Songs are
(MIDI note, duration) pairs uploaded to the iRobot Create; here they are
plain data the event stream references — song 1 = lost, 2 = recovered,
3 = lost (long), 4 = gold-waypoint jingle ("rickroll"), 5 = pickup jingle
("baby shark").  The filter/mission layers emit song NUMBERS (MCLOutput.song,
MissionLeg.song); `encode_store_song`/`encode_play_song` turn those into the
Create Open Interface byte sequences the reference's `store_song`/`play_song`
services carry (songs_lib.cpp:63-143 builds the payloads; the
create_fundamentals driver frames them as OI opcodes 140/141).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

# MIDI note numbers (songs_lib.hpp / songs_lib.cpp:13-55 note constants).
A3, D4, E4, F4, G4, A4, B4, D5, E5, G5 = 57, 62, 64, 65, 67, 69, 71, 74, 76, 79
# Durations in driver ticks (songs_lib.cpp:7-10): MEASURE = 80 ->
# quarter 20, dotted-eighth 15, sixteenth 5 (1 tick = 1/64 s on the Create).
MEASURE = 80
Q = MEASURE // 4        # 20
Ed = MEASURE * 3 // 16  # 15
S = MEASURE // 16       # 5

Song = List[Tuple[int, int]]

SONGS: Dict[int, Song] = {
    # "Lost" (songs_lib.cpp store1)
    1: [(A3, S), (D4, S)],
    # "Recovered / juhu" (store2)
    2: [(D4, S), (G4, Q), (G4, S), (G4, S), (F4, Q)],
    # Long lost (store3)
    3: [(A3, Q), (A3, Q), (A3, Q), (D4, Q)],
    # Gold jingle (store4, rickroll)
    4: [(D4, Q), (E4, Q), (G4, Q), (E4, Q), (B4, Ed), (B4, Q), (A4, Q),
        (D4, Q), (E4, Q), (G4, Q), (E4, Q), (A4, Ed), (A4, Q), (G4, Q)],
    # Pickup jingle (store5, baby shark — first phrase, cleaned pairing;
    # the RAW reference payload with its ragged-pairing quirk is in
    # REFERENCE_SONG_BYTES[5]).
    5: [(D4, Q), (E4, Q), (G4, Ed), (G4, Ed), (G4, Ed), (G4, S), (G4, S),
        (G4, S), (D4, Ed), (E4, Ed), (G4, S), (G4, S), (G4, S), (G4, S),
        (G4, S), (G4, S)],
}

SONG_LOST = 1
SONG_RECOVERED = 2
SONG_LOST_LONG = 3
SONG_GOLD = 4
SONG_PICKUP = 5

# ---------------------------------------------------------------------------
# Serial transport: Create Open Interface opcodes.
#
# The reference uploads five songs over the create_fundamentals `store_song`
# service and triggers them via `play_song` (songs_lib.cpp:63-143); on the
# wire those become iRobot Create OI "Song" (opcode 140: [140, number,
# n_notes, note1, dur1, ...]) and "Play" (opcode 141: [141, number]) frames.
# REFERENCE_SONG_BYTES reproduces songs_lib.cpp's payload arrays BYTE FOR
# BYTE, including the store5 quirk: each line of the baby-shark array ends
# with a bare `g4,` (songs_lib.cpp:100-105) so from the 9th pair onward the
# (note, duration) pairing is shifted — the base receives e.g. (g4 for 62
# ticks) then (note 15 for 64 ticks).  Preserved verbatim: this is the byte
# sequence the reference actually ships.

OPCODE_SONG = 140
OPCODE_PLAY = 141
MAX_OI_NOTES = 16  # OI spec: a song holds at most 16 notes.

_BABY_SHARK_LINE1 = [D4, Q, E4, Q, G4, Ed, G4, Ed, G4, Ed,
                     G4, S, G4, S, G4, S, G4]          # trailing bare note!
_BABY_SHARK_LINE2 = [D4, Ed, E4, Ed, G4, S, G4, S, G4, S,
                     G4, S, G4, S, G4, S, G4]          # trailing bare note!

REFERENCE_SONG_BYTES: Dict[int, List[int]] = {
    1: [A3, S, D4, S],                                   # songs_lib.cpp:79-82
    2: [D4, S, G4, Q, G4, S, G4, S, F4, Q],              # songs_lib.cpp:84-87
    3: [A3, Q, A3, Q, A3, Q, D4, Q],                     # songs_lib.cpp:89-92
    4: [D4, Q, E4, Q, G4, Q, E4, Q, B4, Ed, B4, Q, A4, Q,
        D4, Q, E4, Q, G4, Q, E4, Q, A4, Ed, A4, Q, G4, Q],  # :94-98
    5: (_BABY_SHARK_LINE1 + _BABY_SHARK_LINE2) * 2,      # songs_lib.cpp:100-105
}

# songs_lib.cpp calls the store service in this order (:108-136).
REFERENCE_UPLOAD_ORDER = (5, 4, 1, 2, 3)


def encode_store_song(number: int, payload: List[int] | None = None) -> bytes:
    """OI "Song" frame for one store_song call: [140, number, n, note, dur, ...].

    `payload` defaults to the reference's raw array for that song number.
    Payloads longer than the OI's 16-note capacity are truncated to the first
    16 (note, duration) pairs — what the Create base itself retains; the
    reference's store5 (34 pairs) exceeds the limit and is truncated the same
    way on real hardware.
    """
    if payload is None:
        payload = REFERENCE_SONG_BYTES[number]
    if not 1 <= number <= 15:
        raise ValueError(f"OI song number must be 1..15, got {number}")
    pairs = len(payload) // 2
    n = min(pairs, MAX_OI_NOTES)
    body = payload[: 2 * n]
    for b in body:
        if not 0 <= b <= 255:
            raise ValueError(f"payload byte out of range: {b}")
    return bytes([OPCODE_SONG, number, n, *body])


def encode_play_song(number: int) -> bytes:
    """OI "Play" frame for one play_song call: [141, number]."""
    if not 1 <= number <= 15:
        raise ValueError(f"OI song number must be 1..15, got {number}")
    return bytes([OPCODE_PLAY, number])


def upload_opcodes() -> List[bytes]:
    """The full `uploadSongs` byte stream, in the reference's service-call
    order (store5, store4, store1, store2, store3 — songs_lib.cpp:108-136)."""
    return [encode_store_song(n) for n in REFERENCE_UPLOAD_ORDER]


def song_events(song_codes) -> List[Tuple[int, int]]:
    """Filter an episode's per-tick song outputs into (tick, song) events."""
    return [(int(t), int(s)) for t, s in enumerate(song_codes) if int(s) != 0]
