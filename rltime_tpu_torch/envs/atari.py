"""Vectorized Atari engine: the DeepMind preprocessing stack, batch-first.

Port of `rltime_tpu/envs/atari.py` (numpy and host code only, no
tensor). One class drives E `ale_py.ALEInterface` instances in lockstep,
optionally over a thread pool (ALE releases the GIL in `act`):

  * noop reset (1..noop_max NOOPs) and fire reset;
  * frameskip with the max-pool of the last two screens;
  * EpisodicLife: a lost life marks `terminated` (no bootstrap) but only
    a real game over resets the emulator;
  * truncation at `max_episode_frames`;
  * grayscale + 84x84 resize (cv2 INTER_AREA when cv2 is importable,
    else the reference's numpy fallback: exact luminance, nearest
    resize);
  * reward clipping for the learner, and the true (unclipped,
    whole-game) score of every finished game for the logs.

Frames are not stacked here: single 84x84 uint8 frames go to the
device, where the actor and the replay build stacks by gather.
`ale_py` is imported when an env is built; without it construction
raises ImportError.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np

from rltime_tpu_torch.config.registry import register
from rltime_tpu_torch.envs.base import EnvSpec, VecEnv

try:
    import cv2
    _HAS_CV2 = True
except ImportError:
    _HAS_CV2 = False


def preprocess_frame(rgb_max: np.ndarray) -> np.ndarray:
    """Luminance grayscale + area-resize to 84x84 uint8."""
    if _HAS_CV2:
        gray = cv2.cvtColor(rgb_max, cv2.COLOR_RGB2GRAY)
        return cv2.resize(gray, (84, 84), interpolation=cv2.INTER_AREA)
    gray = (0.299 * rgb_max[..., 0] + 0.587 * rgb_max[..., 1]
            + 0.114 * rgb_max[..., 2]).astype(np.uint8)
    ys = np.linspace(0, gray.shape[0] - 1, 84).astype(int)
    xs = np.linspace(0, gray.shape[1] - 1, 84).astype(int)
    return gray[np.ix_(ys, xs)]


class _AtariLane:
    """One emulator instance + its wrapper state."""

    def __init__(self, rom: str, seed: int, noop_max: int,
                 frameskip: int, episodic_life: bool, fire_reset: bool,
                 max_episode_frames: int):
        from ale_py import ALEInterface, roms
        self.ale = ALEInterface()
        self.ale.setInt("random_seed", seed)
        self.ale.setFloat("repeat_action_probability", 0.0)
        self.ale.loadROM(getattr(roms, rom))
        self.actions = self.ale.getMinimalActionSet()
        self.noop_max = noop_max
        self.frameskip = frameskip
        self.episodic_life = episodic_life
        self.fire_reset = fire_reset and len(self.actions) >= 3
        self.max_episode_frames = max_episode_frames
        self.rng = np.random.default_rng(seed)
        self._buf = np.zeros((2, *self.ale.getScreenDims(), 3), np.uint8)
        self.lives = 0
        self.frame_count = 0

    def _screen(self, i):
        self.ale.getScreenRGB(self._buf[i])

    def _fresh_frame(self) -> np.ndarray:
        """Both pooled screens from the current one."""
        self._screen(0)
        self._buf[1] = self._buf[0]
        return preprocess_frame(self._buf.max(axis=0))

    def reset_episode(self) -> np.ndarray:
        self.ale.reset_game()
        for _ in range(int(self.rng.integers(1, self.noop_max + 1))):
            self.ale.act(0)  # NOOP
            if self.ale.game_over():
                self.ale.reset_game()
        if self.fire_reset:
            self.ale.act(self.actions[1])  # FIRE
            if self.ale.game_over():
                self.ale.reset_game()
        self.lives = self.ale.lives()
        self.frame_count = 0
        return self._fresh_frame()

    def step(self, action_idx: int):
        """-> (frame, summed reward, terminated, truncated, game ended)."""
        a = self.actions[action_idx]
        total = 0.0
        for k in range(self.frameskip):
            total += self.ale.act(a)
            if k >= self.frameskip - 2:
                self._screen(k - (self.frameskip - 2))
            if self.ale.game_over():
                break
        self.frame_count += self.frameskip
        game_over = self.ale.game_over()
        lost_life = self.episodic_life and self.ale.lives() < self.lives
        terminated = game_over or lost_life
        truncated = (not terminated
                     and self.frame_count >= self.max_episode_frames)
        frame = preprocess_frame(self._buf.max(axis=0))
        if game_over or truncated:
            frame = self.reset_episode()
        elif lost_life:
            # a life-loss boundary keeps the emulator's state; FIRE (where
            # the game needs it) and a fresh screen for the next obs
            if self.fire_reset:
                self.ale.act(self.actions[1])
            self.lives = self.ale.lives()
            frame = self._fresh_frame()
        return frame, total, terminated, truncated, game_over or truncated


@register("atari")
class AtariVecEnv(VecEnv):
    def __init__(self, num_envs: int, rom: str = "pong", seed: int = 0,
                 noop_max: int = 30, frameskip: int = 4,
                 episodic_life: bool = True, fire_reset: bool = True,
                 clip_rewards: bool = True,
                 max_episode_frames: int = 108_000,
                 num_threads: int = 0):
        try:
            import ale_py  # noqa: F401
        except ImportError:
            raise ImportError(
                "ale_py is not installed; AtariVecEnv unavailable "
                "(SURVEY.md §7: add ale-py for real Atari runs)") from None
        self.num_envs = num_envs
        self.clip_rewards = clip_rewards
        self._lanes = [
            _AtariLane(rom, seed + i, noop_max, frameskip,
                       episodic_life, fire_reset, max_episode_frames)
            for i in range(num_envs)
        ]
        self.spec = EnvSpec((84, 84), np.uint8,
                            len(self._lanes[0].actions))
        self._pool = (ThreadPoolExecutor(num_threads)
                      if num_threads > 0 else None)
        # EpisodicLife makes a `done` return per LIFE; learning curves
        # compare on the whole game's unclipped score
        self._game_score = np.zeros((num_envs,), np.float64)
        self.completed_scores: list = []

    def reset(self, seed: int = 0) -> np.ndarray:
        self._game_score[:] = 0.0
        return np.stack([lane.reset_episode() for lane in self._lanes])

    def pop_completed_scores(self):
        s, self.completed_scores = self.completed_scores, []
        return s

    def step(self, actions: np.ndarray):
        if self._pool is not None:
            results = list(self._pool.map(
                lambda la: la[0].step(int(la[1])),
                zip(self._lanes, actions)))
        else:
            results = [lane.step(int(a))
                       for lane, a in zip(self._lanes, actions)]
        obs = np.stack([r[0] for r in results])
        rew = np.array([r[1] for r in results], np.float32)
        term = np.array([r[2] for r in results], bool)
        trunc = np.array([r[3] for r in results], bool)
        game_over = np.array([r[4] for r in results], bool)
        self._game_score += rew
        for i in np.nonzero(game_over)[0]:
            self.completed_scores.append(float(self._game_score[i]))
            self._game_score[i] = 0.0
        if self.clip_rewards:
            rew = np.sign(rew)
        return obs, rew, term, trunc

    def close(self):
        if self._pool is not None:
            self._pool.shutdown()
            self._pool = None
