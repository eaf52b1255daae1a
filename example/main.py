#!/usr/bin/env python3
"""Playback example (parity with the reference's example/main.go).

Decodes an MP3 through the public Decoder and plays it on the default audio
device when an audio backend (simpleaudio) is installed; otherwise writes a
WAV file, by default next to the input.

Usage: python example/main.py input.mp3 [output.wav]

Without an MP3 at hand, write one with the stream generator:
  python -c "from go_mp3_tpu import synth; open('demo.mp3', 'wb').write(
      synth.generate_stream(synth.STEREO, 385))"
"""

from __future__ import annotations

import struct
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from go_mp3_tpu import Decoder  # noqa: E402


def wav_header(n_pcm_bytes: int, sample_rate: int) -> bytes:
    """Minimal RIFF/WAVE header for s16le stereo."""
    byte_rate = sample_rate * 4
    return (
        b"RIFF"
        + struct.pack("<I", 36 + n_pcm_bytes)
        + b"WAVEfmt "
        + struct.pack("<IHHIIHH", 16, 1, 2, sample_rate, byte_rate, 4, 16)
        + b"data"
        + struct.pack("<I", n_pcm_bytes)
    )


def main() -> None:
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    src = sys.argv[1]
    dst = sys.argv[2] if len(sys.argv) > 2 else str(Path(src).with_suffix(".wav"))

    with open(src, "rb") as f:
        d = Decoder(f)
        print(f"{src}: {d.sample_rate()} Hz, {d.duration():.2f}s, "
              f"{d.sample_count()} samples")

        try:  # live playback when an audio stack exists
            import simpleaudio  # noqa: F401

            pcm = d.read_all()
            play = simpleaudio.play_buffer(pcm, 2, 2, d.sample_rate())
            play.wait_done()
            return
        except ImportError:
            pass

        # pull-based streaming decode into a WAV (the decoder is an
        # io.Reader-style object; we stream rather than materialize)
        with open(dst, "wb") as out:
            out.write(wav_header(d.length(), d.sample_rate()))
            while True:
                chunk = d.read(1 << 16)
                if not chunk:
                    break
                out.write(chunk)
        print(f"wrote {dst}")


if __name__ == "__main__":
    main()
