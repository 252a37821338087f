"""A GAN on MNIST: an MLP generator and discriminator trained in one
program.

Reference parity: paddle_tpu/models/gan.py (v1_api_demo/gan).  Both
updates live in one Program, two ``minimize`` passes (D, then G), and the
executor's several-autodiff semantics take each gradient at the values
the program-order forward saw: G's gradient reads D's parameters from
before D's update (core/executor.py ``_StepPlan``).
"""
from .. import layers, optimizer
from ..core.program import default_main_program

__all__ = ['generator', 'discriminator', 'build', 'NOISE_DIM']

NOISE_DIM = 64


def generator(noise, out_dim=784, hidden=256):
    h1 = layers.fc(input=noise, size=hidden, act='relu',
                   param_attr='g_fc1_w', bias_attr='g_fc1_b')
    h2 = layers.fc(input=h1, size=hidden, act='relu',
                   param_attr='g_fc2_w', bias_attr='g_fc2_b')
    return layers.fc(input=h2, size=out_dim, act='tanh',
                     param_attr='g_out_w', bias_attr='g_out_b')


def discriminator(img, hidden=256, prefix='d_'):
    h1 = layers.fc(input=img, size=hidden, act='relu',
                   param_attr=prefix + 'fc1_w', bias_attr=prefix + 'fc1_b')
    h2 = layers.fc(input=h1, size=hidden, act='relu',
                   param_attr=prefix + 'fc2_w', bias_attr=prefix + 'fc2_b')
    return layers.fc(input=h2, size=1, act=None,
                     param_attr=prefix + 'out_w', bias_attr=prefix + 'out_b')


def build(img_dim=784, lr=2e-4):
    """Returns (img, noise, d_loss, g_loss, fake).  Call inside a
    program_guard; both losses already have their minimize() appended
    (Adam, beta1 0.5: D's parameters, then G's)."""
    img = layers.data(name='img', shape=[img_dim], dtype='float32')
    noise = layers.data(name='noise', shape=[NOISE_DIM], dtype='float32')

    fake = generator(noise, out_dim=img_dim)
    logit_real = discriminator(img)
    logit_fake = discriminator(fake)

    ones = layers.fill_constant_batch_size_like(
        input=logit_real, shape=[-1, 1], dtype='float32', value=1.0)
    zeros = layers.fill_constant_batch_size_like(
        input=logit_fake, shape=[-1, 1], dtype='float32', value=0.0)

    d_loss = layers.mean(
        x=layers.sums(input=[
            layers.sigmoid_cross_entropy_with_logits(x=logit_real,
                                                     label=ones),
            layers.sigmoid_cross_entropy_with_logits(x=logit_fake,
                                                     label=zeros),
        ]))
    g_loss = layers.mean(
        x=layers.sigmoid_cross_entropy_with_logits(x=logit_fake,
                                                   label=ones))

    prog = default_main_program()
    d_params = [p for p in prog.global_block().all_parameters()
                if p.name.startswith('d_')]
    g_params = [p for p in prog.global_block().all_parameters()
                if p.name.startswith('g_')]

    optimizer.AdamOptimizer(learning_rate=lr, beta1=0.5).minimize(
        d_loss, parameter_list=[p.name for p in d_params])
    optimizer.AdamOptimizer(learning_rate=lr, beta1=0.5).minimize(
        g_loss, parameter_list=[p.name for p in g_params])
    return img, noise, d_loss, g_loss, fake
