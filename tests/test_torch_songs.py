"""utils/songs against the JAX package's: the song table, the reference's
raw payloads, every OI frame and the upload stream byte for byte, the
same refusals, and the event filter."""
import pytest
import torch

from montecarlolocalisation_tpu.utils import songs as jsongs
from montecarlolocalisation_tpu_torch.utils import songs as tsongs

torch.set_num_threads(1)


def test_tables_equal_jax():
    assert tsongs.SONGS == jsongs.SONGS
    assert tsongs.REFERENCE_SONG_BYTES == jsongs.REFERENCE_SONG_BYTES
    assert tsongs.REFERENCE_UPLOAD_ORDER == jsongs.REFERENCE_UPLOAD_ORDER
    for name in ("SONG_LOST", "SONG_RECOVERED", "SONG_LOST_LONG",
                 "SONG_GOLD", "SONG_PICKUP", "OPCODE_SONG", "OPCODE_PLAY",
                 "MAX_OI_NOTES"):
        assert getattr(tsongs, name) == getattr(jsongs, name)


@pytest.mark.parametrize("number", [1, 2, 3, 4, 5])
def test_frames_equal_jax(number):
    assert tsongs.encode_store_song(number) == jsongs.encode_store_song(
        number)
    payload = [n for pair in tsongs.SONGS[number] for n in pair]
    assert tsongs.encode_store_song(number, payload) == \
        jsongs.encode_store_song(number, payload)
    assert tsongs.encode_play_song(number) == jsongs.encode_play_song(number)


def test_upload_stream_and_refusals():
    assert tsongs.upload_opcodes() == jsongs.upload_opcodes()
    assert b"".join(tsongs.upload_opcodes()) == b"".join(
        jsongs.upload_opcodes())
    for bad in (0, 16):
        for mod in (tsongs, jsongs):
            with pytest.raises(ValueError):
                mod.encode_play_song(bad)
            with pytest.raises(ValueError):
                mod.encode_store_song(bad, [60, 10])
    for mod in (tsongs, jsongs):
        with pytest.raises(ValueError):
            mod.encode_store_song(1, [300, 10])


def test_song_events():
    codes = [0, 1, 0, 0, 2, 0, 4]
    want = jsongs.song_events(codes)
    assert tsongs.song_events(codes) == want == [(1, 1), (4, 2), (6, 4)]
    assert tsongs.song_events(torch.tensor(codes, dtype=torch.int32)) == want
