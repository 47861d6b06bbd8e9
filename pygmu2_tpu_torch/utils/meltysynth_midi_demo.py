"""Live MIDI -> SoundFont demo on the port.

Counterpart of the JAX package's ``scripts/meltysynth_midi_demo.py`` (which
imports the JAX package). With a MIDI input port (``--port``, needs
``mido``) it streams a ``MeltysynthPE`` through the audio device (needs
``sounddevice``), its notes fed by a ``MidiInPE``; without one it renders a
scripted arpeggio to a WAV file. The synth renders on ``device`` (default
``"cuda"``; ``"cpu"`` runs the kernels' plain versions). Without a font
argument it generates a one-sample font (``soundfont/build``).

Usage: ``python -m pygmu2_tpu_torch.utils.meltysynth_midi_demo
[soundfont.sf2] [--port NAME] [--out FILE.wav] [--device cuda|cpu]``
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np

SAMPLE_RATE = 44100
ARPEGGIO = (60, 64, 67, 72, 67, 64, 60)  # the scripted notes, 6300 samples each
NOTE_SAMPLES = 6300
DEFAULT_OUT = os.path.join(tempfile.gettempdir(), "meltysynth_demo.wav")


def demo_font_bytes() -> bytes:
    """The generated demo font: one looped 261.63 Hz sample at key 60."""
    from pygmu2_tpu_torch.soundfont.build import build_sf2, make_looped_sample

    return build_sf2([{
        "data": make_looped_sample(261.63, harmonics=5),
        "rate": SAMPLE_RATE, "root_key": 60, "loop": True,
        "attack_tc": -9500, "release_tc": -4500,
    }])


def scripted_arpeggio(sf_path: str, device="cuda") -> np.ndarray:
    """The arpeggio through ``MeltysynthPE(block_size=256)``: each note on,
    6300 samples rendered on ``device``, the note off. (T, 2) float32."""
    import pygmu2_tpu_torch as pg

    pg.set_sample_rate(SAMPLE_RATE)
    synth_pe = pg.MeltysynthPE(sf_path, block_size=256)
    renderer = pg.NullRenderer(device=device)
    renderer.set_source(synth_pe)
    renderer.start()
    synth = synth_pe.synthesizer
    chunks = []
    try:
        for i, key in enumerate(ARPEGGIO):
            synth.note_on(0, key, 100)
            chunks.append(synth_pe.render(i * NOTE_SAMPLES, NOTE_SAMPLES, device=device).data)
            synth.note_off(0, key)
    finally:
        renderer.stop()
    return np.concatenate(chunks)


def live(sf_path: str, port: str, device="cuda") -> None:
    """Streams the synth through the audio device, fed by the MIDI port,
    until interrupted."""
    import pygmu2_tpu_torch as pg

    pg.set_sample_rate(SAMPLE_RATE)
    synth_pe = pg.MeltysynthPE(sf_path, block_size=256)

    def callback(sample_index, msg):
        s = synth_pe.synthesizer
        if msg.type == "note_on" and msg.velocity > 0:
            s.note_on(msg.channel, msg.note, msg.velocity)
        elif msg.type in ("note_off", "note_on"):
            s.note_off(msg.channel, msg.note)

    midi_in = pg.MidiInPE(port_name=port, callback=callback)
    # the drain's mono silence on the synth's two channels, mixed first so
    # that an event fed before a block sounds in it
    drain = pg.SpatialPE(pg.GainPE(midi_in, 0.0), method=pg.SpatialAdapter(channels=2))
    renderer = pg.AudioRenderer(blocksize=256, device=device)
    renderer.set_source(pg.MixPE(drain, synth_pe))
    with renderer:
        renderer.start()
        renderer.stream_start()
        print("playing — ctrl-c to stop")
        try:
            renderer.stream_wait()
        except KeyboardInterrupt:
            pass


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="live MIDI -> SoundFont demo")
    parser.add_argument("soundfont", nargs="?", default=None)
    parser.add_argument("--port", default=None, help="MIDI input port (needs mido)")
    parser.add_argument("--out", default=DEFAULT_OUT,
                        help="the scripted demo's WAV when no port is given")
    parser.add_argument("--device", default="cuda", help="where the synth renders")
    args = parser.parse_args(argv)

    with tempfile.TemporaryDirectory() as tmp:
        sf_path = args.soundfont
        if sf_path is None:
            sf_path = os.path.join(tmp, "demo.sf2")
            with open(sf_path, "wb") as f:
                f.write(demo_font_bytes())
            print("using a generated demo SoundFont")

        have_midi = False
        if args.port is not None:
            try:
                import mido  # noqa: F401

                have_midi = True
            except ImportError:
                print("mido is missing: rendering the scripted demo instead")
        if have_midi:
            live(sf_path, args.port, device=args.device)
            return 0

        from pygmu2_tpu_torch.utils import wavio

        wavio.write_wav(args.out, scripted_arpeggio(sf_path, device=args.device), SAMPLE_RATE)
        print(f"no MIDI port; wrote the scripted demo to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
