"""PPO: clipped-surrogate actor-critic over vectorized env rollouts
(mirrors ``fpyv_tpu.rl.ppo``).

One ``train_iteration`` = a T-step rollout over N envs (the default per-step
loop, or a ``rollout_fn`` such as the in-kernel vision rollout), GAE, then E
epochs of minibatched Adam updates with global-norm clipping. The learner is
plain PyTorch (autograd through ``nn.Module``s); the JAX package computes it
in XLA outside any Pallas kernel.

Where JAX threads immutable params, optimizer state and a PRNG key through
the iteration, the port updates the module, the ``torch.optim.Adam`` and the
``torch.Generator`` held by :class:`PpoState` in place and returns a new
``PpoState`` that holds them. ``scan_train`` is a host loop.

Matching optax: ``optax.clip_by_global_norm`` scales by ``max_norm / norm``
with no epsilon (``clip_grad_norm_`` adds 1e-6, so the rule is written out);
``optax.adam(lr, eps=1e-5)`` is ``torch.optim.Adam(lr=lr, eps=1e-5)``; the
advantage std is the population std (``correction=0``).
``PpoConfig.adam_mu_dtype="bf16"`` (optax's ``adam(mu_dtype=bfloat16)``)
takes :class:`AdamBf16Mu`, the port's own Adam step, since
``torch.optim.Adam`` keeps its moments in the parameters' dtype.

:func:`make_recurrent_ppo` is the GRU policy's learner (JAX's
``make_recurrent_ppo``): the hidden state rides the env carry, and the
learner replays whole env sequences from the iteration's first hidden.

``PpoConfig.axis_name`` (JAX's) names the mesh axis
(:func:`fpyv_tpu_torch.parallel.mesh.make_mesh`) whose ranks average each
minibatch's gradients, with one all-reduce, before the clip; the
rollouts take a ``part`` (this rank's rows of the bank) and draw the
action noise for the whole bank (:mod:`fpyv_tpu_torch.parallel.train`).

Spans (:func:`fpyv_tpu_torch.utils.profiling.span`, recorded under
``torch.profiler`` only): each ``train_iteration`` is a ``ppo.iteration``
holding ``ppo.rollout``, ``ppo.gae`` (the bootstrap value, GAE and the
flatten), a ``ppo.shuffle`` an epoch, a ``ppo.minibatch`` a minibatch
(``ppo.loss``: forward and terms; ``ppo.backward``: the gradients, their
all-reduce under ``axis_name`` included; ``ppo.clip``; ``ppo.adam``) and
``ppo.info``.

CUDA graphs (:class:`_Graphs`): where the parameters are on CUDA, the
optimizer is the capturable ``torch.optim.Adam`` that :func:`make_optimizer`
gives there, and no mesh axis averages the gradients, ``make_ppo`` captures
each minibatch position's update (the same :func:`_minibatch`: forward, PPO
terms, backward, clip, Adam) once as a CUDA graph and replays it, one launch
a minibatch in place of some two hundred and no host sync. The first
iteration, and the first after what the update touches changed, run eagerly
on a side stream (the warm-up, which also makes Adam's state); the next one
captures. A replayed minibatch is a ``ppo.replay`` span, a
capture a ``ppo.capture`` holding the captured spans; ``ppo.loss``,
``ppo.backward``, ``ppo.clip`` and ``ppo.adam`` open only in eager
minibatches and in a capture. Everywhere else (the CPU, ``AdamBf16Mu``,
``axis_name``, :func:`make_recurrent_ppo`) the update runs eagerly; under
``axis_name`` on CUDA with the same capturable Adam, so that a rank of a
mesh steps as one process does.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import warnings
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from fpyv_tpu_torch.device import divisor
from fpyv_tpu_torch.envs.base import Part
from fpyv_tpu_torch.rl.gae import compute_gae
from fpyv_tpu_torch.utils.profiling import span


@dataclass(frozen=True)
class PpoConfig:
    num_envs: int = 4096
    num_steps: int = 32  # T per rollout
    update_epochs: int = 4
    num_minibatches: int = 8
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    ent_coef: float = 0.001
    vf_coef: float = 0.5
    max_grad_norm: float = 0.5
    learning_rate: float = 3e-4
    # Adam first-moment dtype: None = float32; "bf16" stores it in bfloat16
    # (AdamBf16Mu; the second moment stays float32)
    adam_mu_dtype: Optional[str] = None
    # shuffle granularity in rows of the flattened (T*N) batch: blocks of
    # consecutive rows (the same timestep across `shuffle_block` envs) move
    # together; in envs for the recurrent learner
    shuffle_block: int = 64
    # the mesh axis whose ranks average each minibatch's gradients before the
    # clip (parallel.mesh.make_mesh binds it); None trains on one process
    axis_name: Optional[str] = None

    def __post_init__(self):
        if self.adam_mu_dtype not in (None, "bf16"):
            raise ValueError(f"adam_mu_dtype must be None or 'bf16', got {self.adam_mu_dtype!r}")


@dataclass
class PpoState:
    params: torch.nn.Module  # the policy; the learner updates it in place
    opt_state: torch.optim.Optimizer
    env_state: Any
    last_obs: Any
    generator: torch.Generator  # shuffles, action noise, kernel seeds
    update_count: int

    def replace(self, **changes) -> "PpoState":
        return dataclasses.replace(self, **changes)


@dataclass
class Transition:
    obs: Any
    action: torch.Tensor
    log_prob: torch.Tensor
    value: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor


_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)
_HALF_LOG_2PIE = 0.5 * math.log(2.0 * math.pi * math.e)


def gaussian_log_prob(mean, log_std, action):
    std = torch.exp(log_std)
    z = (action - mean) / std
    return torch.sum(-0.5 * z**2 - log_std - _HALF_LOG_2PI, dim=-1)


def gaussian_entropy(log_std):
    return torch.sum(log_std + _HALF_LOG_2PIE, dim=-1)


def _tree_map(fn, x, *rest):
    """``fn`` over the leaves of ``x`` (a tensor or a dict of them), each
    with the same leaf of every tree in ``rest``."""
    if isinstance(x, dict):
        return {k: fn(v, *(r[k] for r in rest)) for k, v in x.items()}
    return fn(x, *rest)


def _leading(x) -> int:
    return (next(iter(x.values())) if isinstance(x, dict) else x).shape[0]


def clip_by_global_norm_(params, max_norm: float) -> torch.Tensor:
    """optax's rule: when the global norm reaches ``max_norm``, every
    gradient becomes ``(g / norm) * max_norm``. Returns the norm."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    trigger = norm < max_norm
    for g in grads:
        g.copy_(torch.where(trigger, g, (g / norm) * max_norm))
    return norm


class AdamBf16Mu(torch.optim.Optimizer):
    """optax 0.2.6's ``adam(lr, eps=eps, mu_dtype=jnp.bfloat16)``, step for
    step: the new first moment ``(1 - b1) * g + b1 * mu`` is computed in
    float32 from the stored bf16 moment, where ``b1 * mu`` is a bf16 product
    with ``b1`` rounded to bf16 (JAX's weakly typed scalar takes the moment's
    dtype); this step's update ``-lr * mu_hat / (sqrt(nu_hat) + eps)`` uses
    that float32 value, and only the stored moment is rounded to bf16. The
    second moment stays float32. The bias corrections ``1 - b**t`` are taken
    in double and rounded to float32, as optax computes them under x64 (in
    float32 without it: one ulp away). The state (``exp_avg`` bf16,
    ``exp_avg_sq`` float32, ``step``) is saved and restored in those dtypes."""

    def __init__(self, params, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            b1, b2, lr, eps = group["b1"], group["b2"], group["lr"], group["eps"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["step"] = 0
                    st["exp_avg"] = torch.zeros_like(p, dtype=torch.bfloat16)
                    st["exp_avg_sq"] = torch.zeros_like(p, dtype=torch.float32)
                g = p.grad
                mu = (1 - b1) * g + torch.tensor(b1, dtype=torch.bfloat16) * st["exp_avg"]
                nu = (1 - b2) * g**2 + b2 * st["exp_avg_sq"]
                st["step"] += 1
                mu_hat = mu / divisor(1.0 - b1 ** st["step"], mu)
                nu_hat = nu / divisor(1.0 - b2 ** st["step"], nu)
                p.add_(-lr * (mu_hat / (torch.sqrt(nu_hat) + eps)))
                st["exp_avg"] = mu.to(torch.bfloat16)
                st["exp_avg_sq"] = nu
        return None

    def load_state_dict(self, state_dict):
        # torch.optim casts floating state to the parameter's dtype on load
        super().load_state_dict(state_dict)
        for st in self.state.values():
            st["exp_avg"] = st["exp_avg"].to(torch.bfloat16)


def make_optimizer(params: torch.nn.Module, config: PpoConfig,
                   capturable: bool = False) -> torch.optim.Optimizer:
    """optax's ``adam(lr, eps=1e-5, mu_dtype=...)`` for ``config``. With
    ``capturable`` and the parameters on CUDA, ``torch.optim.Adam`` keeps its
    step count on the device and takes its bias corrections there, so that
    its step can be captured in a CUDA graph (``make_ppo``'s learners);
    ``AdamBf16Mu`` is never capturable."""
    if config.adam_mu_dtype == "bf16":
        return AdamBf16Mu(params.parameters(), lr=config.learning_rate, eps=1e-5)
    capturable = capturable and all(p.is_cuda for p in params.parameters())
    opt = torch.optim.Adam(params.parameters(), lr=config.learning_rate, eps=1e-5,
                           capturable=capturable)

    def keep_capturable(optimizer):
        # a loaded state carries its writer's flag; keep this one's, and its
        # step counts where it keeps them (the device, else the CPU)
        for group in optimizer.param_groups:
            group["capturable"] = capturable
            for p in group["params"]:
                st = optimizer.state.get(p, {})
                if "step" in st:
                    st["step"] = st["step"].to(device=p.device if capturable else "cpu",
                                               dtype=torch.float32)

    opt.register_load_state_dict_post_hook(keep_capturable)
    return opt


def action_noise(mean: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """The rollout's standard normal action noise, shaped as ``mean``, drawn
    from ``generator`` on its own device and moved to ``mean``'s."""
    return torch.randn(mean.shape, generator=generator, dtype=mean.dtype,
                       device=generator.device).to(mean.device)


def _bank_noise(mean: torch.Tensor, generator: torch.Generator,
                part: Optional[Part]) -> torch.Tensor:
    """:func:`action_noise` for this rank's rows ``part`` of the bank: drawn
    at the whole bank's shape and sliced (all of it when None)."""
    if part is None:
        return action_noise(mean, generator)
    whole = mean.new_empty((part.n,) + tuple(mean.shape[1:]))
    return action_noise(whole, generator)[part.lo:part.hi]


def permutation(n: int, generator: torch.Generator, device) -> torch.Tensor:
    """An epoch's shuffle of ``n`` blocks."""
    return torch.randperm(n, generator=generator, device=generator.device).to(device)


def _numerics(net):
    """The net's numerics scope for its backward pass (the pixel net's
    ``flax_reductions``), or none."""
    scope = getattr(net, "numerics", None)
    return scope() if scope is not None else contextlib.nullcontext()


# torch.optim's warning on a capturable optimizer stepped outside a capture
_UNCAPTURED = "This instance was constructed with capturable=True"


def _update(net, opt, loss, config: PpoConfig) -> None:
    with span("ppo.backward"):
        opt.zero_grad(set_to_none=True)
        with _numerics(net):
            loss.backward()
        if config.axis_name is not None:
            # JAX pmeans the gradients before optax's clip; the import waits
            # for the first call, since parallel.train imports this module
            from fpyv_tpu_torch.parallel.mesh import axis_mesh, pmean_

            pmean_([p.grad for p in net.parameters() if p.grad is not None],
                   axis_mesh(config.axis_name))
    with span("ppo.clip"):
        clip_by_global_norm_(net.parameters(), config.max_grad_norm)
    with span("ppo.adam"), warnings.catch_warnings():
        # a capturable Adam steps eagerly in a graph's warm-up and on a mesh
        warnings.filterwarnings("ignore", message=_UNCAPTURED)
        opt.step()


def _minibatch(net, opt, config: PpoConfig, loss_fn, losses, metrics) -> None:
    """One minibatch's update: ``loss_fn() -> (loss, terms)`` under
    ``ppo.loss``, then :func:`_update`; the loss and terms are appended."""
    with span("ppo.loss"):
        loss, m = loss_fn()
    _update(net, opt, loss, config)
    losses.append(loss.detach())
    for k, v in m.items():
        metrics.setdefault(k, []).append(v.detach())


def _graphable(net, opt, config: PpoConfig) -> bool:
    """Whether :class:`_Graphs` can run this learner's update: the
    parameters on CUDA, the capturable ``torch.optim.Adam`` (a subclass may
    step on the host), no mesh axis (the all-reduce stays eager)."""
    return (config.axis_name is None and type(opt) is torch.optim.Adam
            and all(g["capturable"] for g in opt.param_groups)
            and all(p.is_cuda for p in net.parameters()))


def _graph_key(net, opt):
    """What a captured update reads and writes in place, and the functions
    it ran: when any of it changes (``opt.load_state_dict``, another net,
    another learning rate, a replaced ``_update``), the graphs are stale."""
    params = tuple((id(p), p.data_ptr()) for p in net.parameters())
    moments = tuple((id(v), v.data_ptr()) for st in opt.state.values() for v in st.values()
                    if torch.is_tensor(v))
    groups = tuple(tuple((k, v) for k, v in g.items() if k != "params")
                   for g in opt.param_groups)
    return id(opt), params, moments, groups, _minibatch, _update, _ppo_terms


class _Graphs:
    """``make_ppo``'s minibatch updates as CUDA graphs, one a minibatch
    position in one memory pool, captured together and replayed.

    The epoch's shuffle fills the static inputs that :meth:`start` returns
    (a full batch, laid out as the eager shuffle's output), and each
    position's graph reads its rows there. A minibatch replays only where
    :func:`_graph_key` reads what the previous iteration left at this batch
    shape and device: so the first iteration, and the first after a change
    (``opt.load_state_dict``, another net or optimizer), run eagerly on a
    side stream (the warm-up, which also makes Adam's state), and the next
    captures the graphs again. The loss and terms are cloned out of the
    graph after each replay."""

    def __init__(self):
        self.stream = None  # the warm-up's and the captures' stream
        self.inputs = None  # (Transition, advantages, targets)
        self.left = None  # the key the last iteration left
        self.graphs = []  # (graph, loss, terms) a minibatch position

    def start(self, batch: Transition, advantages, targets):
        """Opens an iteration: its static inputs."""
        new = _leaves(batch) + [advantages, targets]
        old = [] if self.inputs is None else _leaves(self.inputs[0]) + list(self.inputs[1:])
        if [(t.shape, t.dtype, t.device) for t in new] != [
                (t.shape, t.dtype, t.device) for t in old]:
            self.stream = torch.cuda.Stream(advantages.device)
            self.inputs = (_map_transition(_empty, batch), _empty(advantages),
                           _empty(targets))
            self.left = None
        return self.inputs

    def finish(self, net, opt) -> None:
        """Closes an iteration."""
        self.left = _graph_key(net, opt)

    def minibatch(self, idx: int, loss_fns, net, opt, config: PpoConfig, losses,
                  metrics) -> None:
        """Position ``idx``'s update (``loss_fns(i)`` is position i's loss
        function), its loss and terms appended as :func:`_minibatch`'s."""
        if _graph_key(net, opt) == self.left:
            if not self.graphs:
                with span("ppo.capture"):
                    self._capture(net, opt, config, loss_fns)
            graph, loss, terms = self.graphs[idx]
            with span("ppo.replay"):
                graph.replay()
            losses.append(loss.clone())
            for k, v in terms.items():
                metrics.setdefault(k, []).append(v.clone())
            return
        self.graphs = []
        main = torch.cuda.current_stream(self.stream.device)
        self.stream.wait_stream(main)
        with torch.cuda.stream(self.stream):
            _minibatch(net, opt, config, loss_fns(idx), losses, metrics)
        main.wait_stream(self.stream)

    def _capture(self, net, opt, config: PpoConfig, loss_fns) -> None:
        pool = torch.cuda.graph_pool_handle()
        for i in range(config.num_minibatches):
            graph, losses, metrics = torch.cuda.CUDAGraph(), [], {}
            with torch.cuda.graph(graph, pool=pool, stream=self.stream):
                _minibatch(net, opt, config, loss_fns(i), losses, metrics)
            self.graphs.append((graph, losses[0], {k: v[0] for k, v in metrics.items()}))


def _empty(x: torch.Tensor) -> torch.Tensor:
    return torch.empty_like(x, memory_format=torch.contiguous_format)


def _map_transition(fn, *ts: Transition) -> Transition:
    """``fn`` over the leaves of Transitions of one layout, leaf by leaf."""
    return Transition(**{f.name: _tree_map(fn, *(getattr(t, f.name) for t in ts))
                         for f in dataclasses.fields(Transition)})


def _leaves(t: Transition) -> list:
    out = []
    _map_transition(out.append, t)
    return out


def _ppo_terms(config: PpoConfig, batch: "Transition", log_prob, value, entropy_log_std,
               advantages, targets):
    """The clipped surrogate, the clipped value loss and the entropy bonus."""
    ratio = torch.exp(log_prob - batch.log_prob)
    adv = (advantages - advantages.mean()) / (advantages.std(correction=0) + 1e-8)
    pg1 = ratio * adv
    pg2 = torch.clamp(ratio, 1.0 - config.clip_eps, 1.0 + config.clip_eps) * adv
    pg_loss = -torch.mean(torch.minimum(pg1, pg2))
    v_clipped = batch.value + torch.clamp(value - batch.value, -config.clip_eps,
                                          config.clip_eps)
    v_loss = 0.5 * torch.mean(torch.maximum((value - targets) ** 2, (v_clipped - targets) ** 2))
    ent = torch.mean(gaussian_entropy(entropy_log_std))
    total = pg_loss + config.vf_coef * v_loss - config.ent_coef * ent
    return total, {"pg_loss": pg_loss, "v_loss": v_loss, "entropy": ent,
                   "approx_kl": torch.mean(batch.log_prob - log_prob)}


def _stack_steps(steps):
    def stack(name):
        vals = [getattr(t, name) for t in steps]
        if isinstance(vals[0], dict):
            return {k: torch.stack([v[k] for v in vals]) for k in vals[0]}
        return torch.stack(vals)

    return Transition(**{f.name: stack(f.name) for f in dataclasses.fields(Transition)})


def _info(losses, metrics, traj, metrics_fn, env_state):
    info = {"loss": torch.stack(losses).mean(),
            "mean_reward": traj.reward.mean(),
            "mean_episode_done": traj.done.to(torch.float32).mean(),
            **{k: torch.stack(v).mean() for k, v in metrics.items()}}
    if metrics_fn is not None:
        info.update(metrics_fn(env_state))
    return info


def make_step_rollout(apply_fn: Callable, env_step: Callable, config: PpoConfig,
                      part: Optional[Part] = None):
    """``make_ppo``'s default rollout: T steps of the policy and
    ``env_step``, one at a time, the action noise drawn from
    ``state.generator``. ``rollout(state) -> (env_state, last_obs, traj)``,
    traj a (T, N, ...) Transition. Under ``part`` the N envs are one rank's
    rows of a larger bank, and the noise is drawn at the whole bank's shape
    and sliced."""

    @torch.no_grad()
    def rollout(state: PpoState):
        env_state, obs, steps = state.env_state, state.last_obs, []
        for _ in range(config.num_steps):
            mean, log_std, value = apply_fn(state.params, obs)
            action = mean + torch.exp(log_std) * _bank_noise(mean, state.generator, part)
            log_prob = gaussian_log_prob(mean, log_std, action)
            env_state, next_obs, reward, done = env_step(env_state, action, state.generator)
            steps.append(Transition(obs=obs, action=action, log_prob=log_prob, value=value,
                                    reward=reward, done=done))
            obs = next_obs
        return env_state, obs, _stack_steps(steps)

    return rollout


def make_ppo(
    apply_fn: Callable,  # apply_fn(params, obs) -> (mean, log_std, value)
    env_step: Optional[Callable],  # env_step(env_state, action, generator)
    #   -> (env_state, obs, reward, done)
    config: PpoConfig,
    metrics_fn: Optional[Callable] = None,  # metrics_fn(env_state) -> dict
    rollout_fn: Optional[Callable] = None,  # replaces the default per-step
    #   rollout: rollout_fn(state) -> (env_state, last_obs, traj), traj a
    #   (T, N, ...) Transition; it draws from state.generator
):
    """Build (init, train_iteration) for a vectorized env.

    ``env_step`` steps the whole env bank with auto-reset inside it:
    actions (N, A) in, obs (N, ...) / reward (N,) / done (N,) out.
    ``metrics_fn`` maps the post-rollout env state to extra scalar metrics
    merged into the iteration info.
    """

    rollout = make_step_rollout(apply_fn, env_step, config) if rollout_fn is None else rollout_fn
    graphs = _Graphs()  # the update's CUDA graphs, where they run

    def init(params: torch.nn.Module, env_state, obs0, generator: torch.Generator) -> PpoState:
        # capturable on CUDA under a mesh axis too, which stays eager: one
        # process and one rank of a mesh step Adam alike
        opt = make_optimizer(params, config, capturable=True)
        return PpoState(params=params, opt_state=opt, env_state=env_state, last_obs=obs0,
                        generator=generator, update_count=0)

    def _loss(params, batch: Transition, advantages, targets):
        mean, log_std, value = apply_fn(params, batch.obs)
        log_prob = gaussian_log_prob(mean, log_std, batch.action)
        return _ppo_terms(config, batch, log_prob, value, log_std, advantages, targets)

    def train_iteration(state: PpoState) -> Tuple[PpoState, Dict[str, torch.Tensor]]:
        with span("ppo.iteration"):
            return iterate(state)

    def iterate(state: PpoState) -> Tuple[PpoState, Dict[str, torch.Tensor]]:
        net, opt, gen = state.params, state.opt_state, state.generator

        def flat(x):
            return x.reshape((-1,) + tuple(x.shape[2:]))

        with torch.no_grad():
            with span("ppo.rollout"):
                env_state, last_obs, traj = rollout(state)
            with span("ppo.gae"):
                _, _, last_value = apply_fn(net, last_obs)
                advantages, targets = compute_gae(traj.reward, traj.value, traj.done,
                                                  last_value, config.gamma, config.gae_lambda)
                batch = Transition(**{f.name: _tree_map(flat, getattr(traj, f.name))
                                      for f in dataclasses.fields(Transition)})
                advantages, targets = flat(advantages), flat(targets)
        batch_size = config.num_steps * _leading(last_obs)
        mb_size = batch_size // config.num_minibatches
        block = max(1, config.shuffle_block)
        if batch_size % (block * config.num_minibatches) != 0:
            block = 1  # exact row shuffle for odd shapes
        n_blocks = batch_size // block
        device = advantages.device
        graphed = graphs if _graphable(net, opt, config) else None
        if graphed is not None:
            into, adv_into, tgt_into = graphed.start(batch, advantages, targets)

        def shuffle(x, out=None):
            xb = x.reshape((n_blocks, block) + tuple(x.shape[1:]))
            if out is None:
                return xb[perm].reshape((batch_size,) + tuple(x.shape[1:]))
            torch.index_select(xb, 0, perm, out=out.view(xb.shape))
            return out

        def loss_fn(idx):
            sl = slice(idx * mb_size, (idx + 1) * mb_size)
            mb = _map_transition(lambda x: x[sl], shuffled)
            return lambda: _loss(net, mb, adv_sh[sl], tgt_sh[sl])

        losses, metrics = [], {}
        for _ in range(config.update_epochs):
            with span("ppo.shuffle"):
                perm = permutation(n_blocks, gen, device)
                if graphed is None:
                    shuffled = _map_transition(shuffle, batch)
                    adv_sh, tgt_sh = shuffle(advantages), shuffle(targets)
                else:  # into the graphs' static inputs
                    shuffled = _map_transition(shuffle, batch, into)
                    adv_sh, tgt_sh = shuffle(advantages, adv_into), shuffle(targets, tgt_into)
            for idx in range(config.num_minibatches):
                with span("ppo.minibatch"):
                    if graphed is None:
                        _minibatch(net, opt, config, loss_fn(idx), losses, metrics)
                    else:
                        graphed.minibatch(idx, loss_fn, net, opt, config, losses, metrics)
        if graphed is not None:
            graphed.finish(net, opt)

        new_state = state.replace(env_state=env_state, last_obs=last_obs,
                                  update_count=state.update_count + 1)
        with span("ppo.info"):
            return new_state, _info(losses, metrics, traj, metrics_fn, env_state)

    return init, train_iteration


def _zero_done(hidden: torch.Tensor, done: torch.Tensor) -> torch.Tensor:
    return torch.where(done[..., None], torch.zeros_like(hidden), hidden)


def make_recurrent_rollout(apply_fn: Callable, env_step: Callable, config: PpoConfig,
                           part: Optional[Part] = None):
    """:func:`make_recurrent_ppo`'s rollout: T steps of the GRU policy and
    ``env_step``; the hidden (the second half of ``state.env_state``) is
    zeroed where ``done`` fires. ``rollout(state) -> ((env_state, hidden),
    last_obs, traj)``; ``part`` as in :func:`make_step_rollout`."""

    @torch.no_grad()
    def rollout(state: PpoState):
        (env_state, hidden), obs, steps = state.env_state, state.last_obs, []
        for _ in range(config.num_steps):
            mean, log_std, value, h2 = apply_fn(state.params, obs, hidden)
            action = mean + torch.exp(log_std) * _bank_noise(mean, state.generator, part)
            log_prob = gaussian_log_prob(mean, log_std, action)
            env_state, next_obs, reward, done = env_step(env_state, action, state.generator)
            hidden = _zero_done(h2, done)
            steps.append(Transition(obs=obs, action=action, log_prob=log_prob, value=value,
                                    reward=reward, done=done))
            obs = next_obs
        return (env_state, hidden), obs, _stack_steps(steps)

    return rollout


def make_recurrent_ppo(
    apply_fn: Callable,  # apply_fn(params, obs, hidden) -> (mean, log_std, value, hidden')
    env_step: Optional[Callable],  # env_step(env_state, action, generator)
    #   -> (env_state, obs, reward, done); done doubles as the hidden's reset
    #   mask, so it marks episode boundaries
    config: PpoConfig,
    metrics_fn: Optional[Callable] = None,
    rollout_fn: Optional[Callable] = None,  # replaces make_recurrent_rollout's
):
    """Recurrent PPO for a GRU policy (JAX's ``make_recurrent_ppo``).

    - The hidden rides ``PpoState.env_state`` as ``(env_state, hidden)``, so
      checkpoints hold it; the rollout zeroes it where ``done`` fires and the
      bootstrap value takes the final hidden.
    - The learner is sequence-minibatched: a minibatch is a set of envs with
      their whole T steps, re-scanned from the iteration's first hidden and
      zeroed at ``batch.done`` (truncated BPTT over the rollout's T). Envs are
      shuffled in blocks of ``max(1, min(shuffle_block, mb_envs))`` envs, or
      singly when that block does not divide both ``num_envs`` and
      ``mb_envs``. The entropy is taken from the first step's ``log_std``.
    - As in JAX, ``num_envs % num_minibatches`` envs drop out of each epoch's
      update (``mb_envs = num_envs // num_minibatches``): the ones the
      permutation puts last.
    """

    rollout = (make_recurrent_rollout(apply_fn, env_step, config) if rollout_fn is None
               else rollout_fn)

    def init(params: torch.nn.Module, env_state, obs0, hidden0: torch.Tensor,
             generator: torch.Generator) -> PpoState:
        return PpoState(params=params, opt_state=make_optimizer(params, config),
                        env_state=(env_state, hidden0), last_obs=obs0, generator=generator,
                        update_count=0)

    def _seq_loss(params, batch: Transition, h0, advantages, targets):
        """batch leaves (T, M, ...); h0 (M, H); advantages, targets (T, M)."""
        h, log_probs, values, log_stds = h0, [], [], []
        for t in range(batch.reward.shape[0]):
            obs_t = _tree_map(lambda x: x[t], batch.obs)
            mean, log_std, value, h2 = apply_fn(params, obs_t, h)
            log_probs.append(gaussian_log_prob(mean, log_std, batch.action[t]))
            values.append(value)
            log_stds.append(log_std)
            h = _zero_done(h2, batch.done[t])
        return _ppo_terms(config, batch, torch.stack(log_probs), torch.stack(values),
                          log_stds[0], advantages, targets)

    def train_iteration(state: PpoState) -> Tuple[PpoState, Dict[str, torch.Tensor]]:
        with span("ppo.iteration"):
            return iterate(state)

    def iterate(state: PpoState) -> Tuple[PpoState, Dict[str, torch.Tensor]]:
        net, opt, gen = state.params, state.opt_state, state.generator
        h0 = state.env_state[1]  # the hidden at the rollout's first step
        with torch.no_grad():
            with span("ppo.rollout"):
                (env_state, hidden), last_obs, traj = rollout(state)
            with span("ppo.gae"):
                _, _, last_value, _ = apply_fn(net, last_obs, hidden)
                advantages, targets = compute_gae(traj.reward, traj.value, traj.done,
                                                  last_value, config.gamma, config.gae_lambda)

        num_envs = traj.reward.shape[1]
        mb_envs = num_envs // config.num_minibatches
        block = max(1, min(config.shuffle_block, mb_envs))
        if num_envs % block or mb_envs % block:
            block = 1
        n_blocks, blocks_per_mb = num_envs // block, mb_envs // block
        device = advantages.device

        def take(x, bidx):  # (T, N, ...) -> the blocks' envs (T, mb_envs, ...)
            xb = x.reshape((x.shape[0], n_blocks, block) + tuple(x.shape[2:]))
            return xb[:, bidx].reshape((x.shape[0], mb_envs) + tuple(x.shape[2:]))

        losses, metrics = [], {}
        for _ in range(config.update_epochs):
            with span("ppo.shuffle"):
                perm = permutation(n_blocks, gen, device)
            for idx in range(config.num_minibatches):
                with span("ppo.minibatch"):
                    bidx = perm[idx * blocks_per_mb:(idx + 1) * blocks_per_mb]
                    mb = Transition(**{f.name: _tree_map(lambda x: take(x, bidx),
                                                         getattr(traj, f.name))
                                       for f in dataclasses.fields(Transition)})
                    h0_mb = h0.reshape((n_blocks, block) + tuple(h0.shape[1:]))[bidx].reshape(
                        (mb_envs,) + tuple(h0.shape[1:]))
                    _minibatch(net, opt, config,
                               lambda: _seq_loss(net, mb, h0_mb, take(advantages, bidx),
                                                 take(targets, bidx)), losses, metrics)

        new_state = state.replace(env_state=(env_state, hidden), last_obs=last_obs,
                                  update_count=state.update_count + 1)
        with span("ppo.info"):
            return new_state, _info(losses, metrics, traj, metrics_fn, env_state)

    return init, train_iteration


def scan_train(train_iteration, state: PpoState, num_iterations: int):
    """Run ``num_iterations`` train iterations; returns (state, infos) where
    each info value gains a leading (num_iterations,) axis. Nothing is read
    back to the host here."""
    infos = []
    for _ in range(num_iterations):
        state, info = train_iteration(state)
        infos.append(info)
    return state, {k: torch.stack([i[k] for i in infos]) for k in infos[0]}
