"""Config schema + checkpoint/resume tests."""

import numpy as np
import pytest

from fdreadoutlibs_jax.formats import wibeth
from fdreadoutlibs_jax.ops import patterns
from fdreadoutlibs_jax.stream import WIBEthFrameProcessor
from fdreadoutlibs_jax.stream.transport import QueueSender
from fdreadoutlibs_jax.utils.checkpoint import (checkpoint_processor,
                                                restore_processor)
from fdreadoutlibs_jax.utils.config import (RawDataProcessorConf,
                                            ReadoutModelConf, load_config)


class TestConfig:
    def test_defaults_roundtrip(self):
        c = RawDataProcessorConf(tpg_algorithm="AbsRS", tpg_threshold=150)
        d = c.as_dict()
        assert d["tpg_algorithm"] == "AbsRS"
        blob = {"rawdataprocessorconf": d,
                "readoutmodelconf": ReadoutModelConf().as_dict()}
        out = load_config(blob)
        assert out["rawdataprocessorconf"].tpg_threshold == 150
        assert out["readoutmodelconf"].tpset_transmission_rate_hz == 200

    def test_unknown_key_rejected(self):
        with pytest.raises(KeyError):
            load_config({"rawdataprocessorconf": {"tppg_threshold": 1}})

    def test_json_file(self, tmp_path):
        import json
        p = tmp_path / "conf.json"
        p.write_text(json.dumps({"rawdataprocessorconf":
                                 {"tpg_threshold": 42, "enable_tpg": True}}))
        out = load_config(p)
        assert out["rawdataprocessorconf"].tpg_threshold == 42

    def test_processor_accepts_dataclass_dict(self):
        conf = RawDataProcessorConf(enable_tpg=True, tpg_threshold=499,
                                    crate_id=1, slot_id=2, link_id=3,
                                    tpg_backend="reference").as_dict()
        proc = WIBEthFrameProcessor(tp_sink=QueueSender())
        proc.conf(conf)
        proc.start()
        assert proc.tpg_cfg.threshold == 499


class TestCheckpointResume:
    def test_bitexact_resume_mid_stream(self, tmp_path):
        """A checkpointed processor resumes bit-exactly mid-stream —
        including an in-flight hit spanning the checkpoint."""
        def make():
            proc = WIBEthFrameProcessor(tp_sink=QueueSender())
            proc.conf({"crate_id": 1, "slot_id": 2, "link_id": 3,
                       "enable_tpg": True, "tpg_threshold": 499,
                       "tp_timeout": 100_000, "tpg_backend": "reference"})
            proc.start()
            return proc

        frames, _ = patterns.pattern_frames(
            "golden", first_timestamp=10_000, crate_id=1, slot_id=2,
            stream_id=3, n_frames=4, channel=7, offset=60)  # spans frames
        wibeth.fake_seq_ids(frames, 0)

        # continuous run
        p_cont = make()
        p_cont.process(frames)
        tps_cont = np.concatenate(p_cont.tp_sink.drain())

        # checkpoint after 2 frames, restore into a fresh processor
        p1 = make()
        p1.process(frames[:2])
        ckpt = tmp_path / "ckpt.npz"
        checkpoint_processor(p1, ckpt)
        part1 = p1.tp_sink.drain()

        p2 = make()
        restore_processor(p2, ckpt)
        p2.process(frames[2:])
        part2 = p2.tp_sink.drain()

        tps_resumed = np.concatenate(part1 + part2)
        np.testing.assert_array_equal(tps_resumed, tps_cont)
        assert p2.metrics.count("num_ts_errors") == 0
        assert p2.metrics.count("num_seq_id_errors") == 0


class TestShardedCheckpoint:
    def test_apa_state_roundtrip(self, tmp_path):
        """Sharded multi-chip state checkpoints and resumes bit-exactly."""
        import numpy as np
        from fdreadoutlibs_jax.ops import TPGConfig
        from fdreadoutlibs_jax.parallel import APAPipeline, make_link_mesh
        from fdreadoutlibs_jax.utils.checkpoint import (load_sharded_state,
                                                        save_sharded_state)
        from tests.test_parallel import make_words

        mesh = make_link_mesh(4)
        cfg = TPGConfig(threshold=120)
        words, _ = make_words(4, n_frames=2, seed=21)

        pipe = APAPipeline(4, cfg, mesh=mesh)
        pipe.process(words)
        save_sharded_state(tmp_path / "apa_state", pipe.state)
        _, n_cont, _ = pipe.process(words)       # continuous run, step 2

        pipe2 = APAPipeline(4, cfg, mesh=mesh)
        pipe2.process(words)                     # builds state structure
        pipe2.state = load_sharded_state(tmp_path / "apa_state", pipe2.state)
        _, n_res, _ = pipe2.process(words)       # resumed step 2
        np.testing.assert_array_equal(np.asarray(n_res), np.asarray(n_cont))
        for k in pipe.state:
            np.testing.assert_array_equal(np.asarray(pipe2.state[k]),
                                          np.asarray(pipe.state[k]),
                                          err_msg=k)

    def test_detector_state_roundtrip(self, tmp_path):
        """The 2-D ('apa' x 'link') detector-scale state pytree checkpoints
        and resumes bit-exactly on a fresh pipeline (each device writes its
        shard; restore re-shards onto the current mesh)."""
        import numpy as np
        from fdreadoutlibs_jax.ops import TPGConfig
        from fdreadoutlibs_jax.parallel import (DetectorPipeline,
                                                make_apa_link_mesh)
        from fdreadoutlibs_jax.utils.checkpoint import (load_sharded_state,
                                                        save_sharded_state)
        from tests.test_detector_pipeline import make_apa_words

        mesh = make_apa_link_mesh(2, 2, backend="cpu")
        cfg = TPGConfig(threshold=120)
        words, _ = make_apa_words(2, 4, n_frames=2, seed=22)

        det = DetectorPipeline(2, 4, cfg, mesh=mesh)
        det.process(words)
        save_sharded_state(tmp_path / "det_state", det.state)
        _, n_cont, _ = det.process(words)

        det2 = DetectorPipeline(2, 4, cfg, mesh=mesh)
        det2.process(words)
        det2.state = load_sharded_state(tmp_path / "det_state", det2.state)
        _, n_res, _ = det2.process(words)
        np.testing.assert_array_equal(np.asarray(n_res), np.asarray(n_cont))


class TestDAPHNEPallasCheckpoint:
    def test_daphne_pallas_resume_bitexact(self, tmp_path):
        """A pallas-backend DAPHNE-stream processor checkpointed
        mid-stream resumes bit-exactly (the restored state must be packed
        into the device stack, not silently re-seeded)."""
        from fdreadoutlibs_jax.formats import daphne
        from fdreadoutlibs_jax.stream.daphne import DAPHNEStreamFrameProcessor

        rng = np.random.default_rng(3)

        def make_batch(seed, pulse_ch):
            r = np.random.default_rng(seed)
            sc = daphne.empty_superchunks(2, stream=True)
            frames = daphne.superchunk_frames(sc, stream=True) \
                .reshape(-1, daphne.STREAM_FRAME_SIZE)
            adcs = (700 + r.normal(0, 15, size=(frames.shape[0], 64, 4))) \
                .astype(np.uint16)
            adcs[12:20, 30:50, pulse_ch] += 400
            daphne.stream_set_adcs(frames, adcs)
            return sc

        def make():
            from fdreadoutlibs_jax.stream.transport import QueueSender
            p = DAPHNEStreamFrameProcessor(tp_sink=QueueSender())
            p.conf({"enable_tpg": True, "tpg_threshold": 60,
                    "tpg_backend": "pallas", "tpg_pallas_interpret": True})
            p.start()
            return p

        batches = [make_batch(s, ch) for s, ch in ((1, 0), (2, 1), (3, 2))]

        p_cont = make()
        for b in batches:
            p_cont.process(b)
        tps_cont = np.concatenate(p_cont.tp_sink.drain()) \
            if p_cont.tp_sink.sent else np.zeros(0)

        p1 = make()
        p1.process(batches[0])
        ckpt = checkpoint_processor(p1, tmp_path / "daphne.npz")
        part1 = p1.tp_sink.drain()

        p2 = make()
        restore_processor(p2, ckpt)
        for b in batches[1:]:
            p2.process(b)
        part2 = p2.tp_sink.drain()
        tps_resumed = np.concatenate(part1 + part2) \
            if (part1 or part2) else np.zeros(0)
        assert len(tps_cont) > 0
        np.testing.assert_array_equal(tps_resumed, tps_cont)
